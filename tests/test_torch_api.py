"""The port's public surface against the JAX package's: every public name
of every `vislam_tpu` module has its counterpart, under the same name, in
the `vislam_tpu_torch` module of the same path.

A module's public names are its `__all__` where it has one, otherwise the
names its own source defines at top level (functions, classes, constants)
that do not start with an underscore. Where the reference lists `__all__`,
the port lists the names in its own `__all__` too. A counterpart is a
module where the reference's name is one and callable where it is.

The only exceptions are the entries of RENAMED and NOT_PORTED, each with
its reason; each entry's counterpart must itself exist.
"""

import ast
import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import vislam_tpu

REF, PORT = "vislam_tpu", "vislam_tpu_torch"

# Reference name -> (port module, port name, reason).
RENAMED = {
    "harris_nms_pallas": ("ops.harris_kernel", "response_nms",
                          "the Pallas response + NMS kernel is the CUDA kernel "
                          "ops/csrc/response_nms.cu behind one wrapper for every family"),
    "harris_nms_auto": ("ops.harris_kernel", "response_nms",
                        "the reference's pick between its kernel and plain jnp; the port's "
                        "wrapper launches the kernel on the card, its twin on the CPU"),
    "match_top2_pallas": ("ops.match_kernel", "match_top2",
                          "the Pallas top-2 match kernel is ops/csrc/match_top2.cu"),
    "fed_evolve_pallas": ("ops.fed_kernel", "fed_evolve",
                          "the Pallas FED kernel is ops/csrc/fed_evolve.cu"),
    "match_descriptors_pallas": ("frontend.match", "match_descriptors",
                                 "the reference's kernel-backed matcher; the port's "
                                 "match_descriptors always runs the match kernel's wrapper"),
}

# Reference module or "module:name" -> (counterparts, reason). A counterpart
# is "package.module:name" in either package.
NOT_PORTED = {
    "data.native_loader": (
        (f"{PORT}.data.png:read_png_grey", f"{PORT}.data.loader:PrefetchLoader"),
        "libpng through ctypes; the port decodes PNGs with its own codec and "
        "prefetches frames on a thread"),
    "eval.opencv_ref": (
        (f"{REF}.eval.opencv_ref:reference_trajectory",),
        "the OpenCV baseline: the card's machine has no cv2, and the tests take "
        "the baseline's rows from the reference"),
    "eval.matchability:opencv_match_pairs": (
        (f"{REF}.eval.matchability:opencv_match_pairs",),
        "the OpenCV baseline's match sets (no cv2 on the card's machine); "
        "tests/test_torch_eval.py takes them from the reference"),
}

# The functions ported last, whose positional parameters must be the
# reference's, in its order (creators add a keyword-only `device`).
SIGNATURES = (
    "lie.quat:quat_identity", "lie.quat:quat_conj", "lie.quat:quat_rotate",
    "lie.quat:quat_from_axis_angle", "lie.se3:se3_identity", "lie.se3:se3_matrix",
    "lie.se3:se3_from_matrix", "inertial.filters:orientation_from_accel",
    "inertial.filters:complementary_step", "inertial.filters:complementary_scan",
    "inertial.preintegration:predict_state", "inertial.preintegration:dead_reckon",
    "frontend.pose:epipolar_inlier_mask", "frontend.match:gather_matched",
)
CREATORS = ("quat_identity", "se3_identity")


def _reference_modules() -> list:
    names = [m.name[len(REF) + 1:] for m in pkgutil.walk_packages(vislam_tpu.__path__, REF + ".")]
    return [n for n in names if n not in NOT_PORTED]


def _defined_names(mod) -> list:
    """Public names a module's own source binds at top level."""
    names = []
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _resolve(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


@pytest.mark.parametrize("module", _reference_modules())
def test_module_surface_is_ported(module):
    ref = importlib.import_module(f"{REF}.{module}")
    port = importlib.import_module(f"{PORT}.{module}")
    listed = hasattr(ref, "__all__")
    names = list(ref.__all__) if listed else _defined_names(ref)
    if listed:
        assert hasattr(port, "__all__"), f"{PORT}.{module} has no __all__"
    missing, unlisted, kinds = [], [], []
    for name in names:
        if name in RENAMED or f"{module}:{name}" in NOT_PORTED:
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        if listed and name not in port.__all__:
            unlisted.append(name)
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.ismodule(r) != inspect.ismodule(p) or callable(r) != callable(p):
            kinds.append(name)
    assert not missing, f"{PORT}.{module} lacks {missing}"
    assert not unlisted, f"{PORT}.{module}.__all__ lacks {unlisted}"
    assert not kinds, f"{PORT}.{module}: not the reference's kind of object: {kinds}"


@pytest.mark.parametrize("name", sorted(RENAMED))
def test_renamed_counterpart_exists(name):
    module, new, reason = RENAMED[name]
    assert reason
    assert callable(getattr(importlib.import_module(f"{PORT}.{module}"), new))
    # The reference still has the name: an entry for a name it dropped is stale.
    assert any(hasattr(importlib.import_module(f"{REF}.{m}"), name)
               for m in ("ops", "ops.harris_kernel", "ops.match_kernel", "ops.fed_kernel"))


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_not_ported_counterpart_exists(entry):
    counterparts, reason = NOT_PORTED[entry]
    assert reason and counterparts
    for path in counterparts:
        _resolve(path)
    module = entry.split(":")[0]
    if ":" in entry:
        assert hasattr(importlib.import_module(f"{REF}.{module}"), entry.split(":")[1])
    else:
        assert importlib.util.find_spec(f"{REF}.{module}") is not None
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"{PORT}.{module}")


def _positional(fn) -> list:
    return [(p.name, p.default if isinstance(p.default, (int, float)) else None)
            for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


@pytest.mark.parametrize("path", SIGNATURES)
def test_ported_function_signature(path):
    ref = _resolve(f"{REF}.{path}")
    port = _resolve(f"{PORT}.{path}")
    assert _positional(port) == _positional(ref)
    extra = [p for p in inspect.signature(port).parameters.values()
             if p.kind not in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    allowed = [("device", "cuda")] if path.split(":")[1] in CREATORS else []
    assert [(p.name, p.default) for p in extra if p.kind == p.KEYWORD_ONLY] == allowed
    assert len(extra) == len(allowed)

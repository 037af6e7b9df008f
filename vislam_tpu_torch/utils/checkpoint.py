"""Engine-state checkpoints keyed by frame index (port of
`vislam_tpu/utils/checkpoint.py`), in the reference's npz format both
ways: a checkpoint the JAX package saved resumes here, and one saved here
loads in the JAX package.

The format: one array per state leaf, `leaf_<i>` in the order of the
state's fields (nested NamedTuples depth first); `__paths`, each leaf's
field path as JAX's `keystr` writes it ('.q_wb', '.window.R_cw');
`__frame_index`; `__bf16_leaves`, the indices of bfloat16 leaves (the
window's descriptor bank), stored widened to float32 (exact); an optional
sidecar `<path>.meta.json`. Loading matches leaves by path, so a field
added to the state since the save takes its registered default. A file
without `__paths` (the reference's positional format of older saves) is
read in the reference's order: positionally when it has as many leaves as
the state, else its leaves are the leading ones and the trailing fields
added since take their defaults; more leaves than the state raises.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from vislam_tpu_torch.engine.engine import require_device
from vislam_tpu_torch.engine.state import EngineState, KeyframeWindow
from vislam_tpu_torch.frontend.features import Features

_NESTED = {"kf_feat": Features, "window": KeyframeWindow}

# Defaults for fields added to the state after checkpoints may exist,
# keyed by field name: an array, or a function of (K, W), the keypoint
# capacity and the window size of the stored state.
_ADDED_FIELD_DEFAULTS = {
    "vi_aligned": np.asarray(False),
    "kf_depths": lambda K, W: np.zeros((K,), np.float32),
    "kf_depth_valid": lambda K, W: np.zeros((K,), bool),
    "shadow_win_p": lambda K, W: np.zeros((W, 3), np.float32),
    "shadow_p_wc": lambda K, W: np.zeros((3,), np.float32),
    "shadow_kf_p_wc": lambda K, W: np.zeros((3,), np.float32),
    "shadow_scale": lambda K, W: np.asarray(0.0, np.float32),
    "origin_p_wc": lambda K, W: np.zeros((3,), np.float32),
    "shadow_origin_p": lambda K, W: np.zeros((3,), np.float32),
    "bootstrap_applies": lambda K, W: np.asarray(0, np.int32),
    "vi_engaged": np.asarray(False),
}


def _leaf_paths(cls=EngineState, prefix=""):
    """Every leaf's keystr path, in the order JAX flattens the state."""
    out = []
    for name in cls._fields:
        sub = _NESTED.get(name) if cls is EngineState else None
        out.extend(_leaf_paths(sub, f"{prefix}.{name}") if sub else [f"{prefix}.{name}"])
    return out


def _leaves(tree):
    for v in tree:
        if isinstance(v, tuple):
            yield from _leaves(v)
        else:
            yield v


def save_checkpoint(path: str, state: EngineState, frame_index: int,
                    meta: dict | None = None) -> None:
    arrays, bf16 = {}, []
    for i, leaf in enumerate(_leaves(state)):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bf16.append(i)
            t = t.float()
        arrays[f"leaf_{i}"] = t.cpu().numpy()
    arrays["__frame_index"] = np.asarray(frame_index)
    arrays["__paths"] = np.asarray(_leaf_paths())
    arrays["__bf16_leaves"] = np.asarray(bf16, np.int64)
    # Uncompressed: the state is a few MB and a save sits on every keyframe.
    np.savez(path, **arrays)
    if meta:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_checkpoint_meta(path: str) -> dict:
    """The sidecar metadata save_checkpoint wrote ({} if absent)."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _default_for(path: str, K: int, W: int):
    name = path.split(".")[-1]
    if name in _ADDED_FIELD_DEFAULTS:
        d = _ADDED_FIELD_DEFAULTS[name]
        return d(K, W) if callable(d) else d
    raise ValueError(f"checkpoint is missing state field {path!r} and no migration "
                     f"default is registered for it")


def load_checkpoint(path: str, device="cuda"):
    """(state on `device`, frame_index) from a checkpoint file."""
    device = require_device(device)
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    if "__paths" in data.files:
        paths = [str(p) for p in data["__paths"][:n]]
    else:
        # Positional: the leading fields of the state, in its order.
        paths = _leaf_paths()
        if n > len(paths):
            raise ValueError(f"{path}: checkpoint has {n} leaves but the state has "
                             f"{len(paths)}; cannot migrate a newer checkpoint")
    stored = {p: data[f"leaf_{i}"] for i, p in enumerate(paths[:n])}
    bf16 = {paths[int(i)] for i in data["__bf16_leaves"]} \
        if "__bf16_leaves" in data.files else set()
    K = int(stored[".kf_feat.uv"].shape[0]) if ".kf_feat.uv" in stored else 0
    W = int(stored[".window.uv"].shape[0]) if ".window.uv" in stored else 0

    def leaf(p):
        a = stored[p] if p in stored else _default_for(p, K, W)
        t = torch.from_numpy(np.array(a))
        return (t.to(torch.bfloat16) if p in bf16 else t).to(device)

    def build(cls, prefix=""):
        return cls(**{name: build(_NESTED[name], f"{prefix}.{name}")
                      if cls is EngineState and name in _NESTED else leaf(f"{prefix}.{name}")
                      for name in cls._fields})

    return build(EngineState), int(data["__frame_index"])

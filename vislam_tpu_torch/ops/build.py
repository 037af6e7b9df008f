"""Build the port's CUDA kernels from `ops/csrc/` and load them with ctypes.

Each source is compiled on first use into `vislam_tpu_torch/_build/`, as a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so ops/csrc/<name>.cu

The file name carries a hash of the source, the headers beside it
(`csrc/*.cuh`) and the flags, so an edited source or header rebuilds and a
stale library is never loaded. `build_all` starts one
nvcc per missing source, all at once. ptxas's report of each kernel
instance (registers, spills, static shared memory) is kept beside the
library and read by `ptxas_report`. A plain C interface
(no PyTorch headers) keeps the build to seconds. A failed build raises with
nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES = ("response_nms", "fed_evolve", "match_top2", "threefry_gumbel")

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source at first use")


def _target(name: str):
    """(source path, library path) for csrc/<name>.cu."""
    src = os.path.join(_CSRC, name + ".cu")
    text = b""
    for path in [src] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            text += f.read()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, os.path.join(_BUILD, f"{name}-{tag}.so")


def build_all(names) -> list:
    """Paths of the built libraries for csrc/<name>.cu of every name,
    building the missing ones with one nvcc process each, all started
    together."""
    targets = [_target(n) for n in names]
    missing = [(src, out) for src, out in targets if not os.path.exists(out)]
    if missing:
        nvcc = nvcc_path()
        os.makedirs(_BUILD, exist_ok=True)
        jobs = []
        for src, out in missing:
            # Build into a temporary name and rename: a concurrent or
            # interrupted build never leaves a half-written library under
            # the final name.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
            jobs.append((src, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, out, tmp, cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed ({proc.returncode}) building {src}:\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            else:
                with open(out + ".ptxas", "w") as f:
                    f.write(stderr)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    return [out for _, out in targets]


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu (built if missing)."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> list:
    """Per kernel instance of csrc/<name>.cu, as ptxas reported it when the
    library was built: (mangled name, registers, spill store bytes, spill
    load bytes, static shared memory bytes)."""
    with open(library_path(name) + ".ptxas") as f:
        text = f.read()
    out = []
    # ptxas prints, per entry function: "Compiling entry function 'X'",
    # "... N bytes spill stores, N bytes spill loads", "Used N registers, ...
    # [N bytes smem, ...]".
    for block in re.split(r"Compiling entry function ", text)[1:]:
        fn = re.match(r"'([^']+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        if fn and regs:
            out.append((fn.group(1), int(regs.group(1)),
                        int(spill.group(1)) if spill else 0, int(spill.group(2)) if spill else 0,
                        int(smem.group(1)) if smem else 0))
    return out

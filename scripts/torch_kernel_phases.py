"""Where the time of one launch goes, phase by phase, in the FED and the
response + NMS kernels, on one NVIDIA card.

    python3 scripts/torch_kernel_phases.py

Builds instrumented copies of `vislam_tpu_torch/ops/csrc/fed_evolve.cu` and
`response_nms.cu` into `vislam_tpu_torch/_build/phases/`: thread 0 of every
block reads `%globaltimer` (ns, the card's clock) and `clock64` (its SM's
cycles) on entry and after each barrier that ends a phase, the barrier
included, into a buffer of its own. The copies are made by inserting that
code at fixed places of the sources; the script fails if a place is gone.
Then, on the images chip_smoke.py uses: each launch of FED's 4- and 8-step
cycles (the wrapper's schedule) and each response family on its two
levels, each launched once to warm up and once to read. Prints per launch
its blocks, the most on one SM, the span from the first block's entry to
the last block's end, and each phase's mean and largest time over the
blocks. The marks add a barrier per phase and a global store per block;
the launch's own time is what chip_smoke.py and torch_kernels_ab.py
measure. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARKS = 16   # (globaltimer, clock64) pairs per block; the last pair's second word is the SM id
_MARK = """
__device__ __forceinline__ void phase_mark(unsigned long long* clk, int k, bool sync = true) {
  if (sync) __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t blk = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  clk[blk * 2 * MARKS + 2 * k] = g;
  clk[blk * 2 * MARKS + 2 * k + 1] = clock64();
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    clk[blk * 2 * MARKS + 2 * MARKS - 1] = sm;
  }
}
"""

# (anchor, replacement) pairs per source; each anchor must occur exactly
# once (`*` after the count: every occurrence).
FED_EDITS = [
    ('#include "smem_once.cuh"', f'#include "smem_once.cuh"\n#define MARKS {MARKS}\n{_MARK}'),
    ("const float* __restrict__ k, Taus taus) {",
     "const float* __restrict__ k, Taus taus, unsigned long long* clk) {\n  phase_mark(clk, 0, false);"),
    ('asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();',
     'asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  phase_mark(clk, 1);'),
    ("along_y<SWP>(L, A, B, e + 3, SH - e - 3, e, SW - e);\n    __syncthreads();",
     "along_y<SWP>(L, A, B, e + 3, SH - e - 3, e, SW - e);\n    phase_mark(clk, 2 * j);"),
    ("to_shared);\n      __syncthreads();", "to_shared);\n      phase_mark(clk, 2 * j + 1);"),
    ("h, h + TH, h, h + TW, k2, half_tau, to_global);",
     "h, h + TH, h, h + TW, k2, half_tau, to_global);\n      phase_mark(clk, 2 * j + 1);"),
    ("const Taus& taus, int B, cudaStream_t s) {",
     "const Taus& taus, int B, cudaStream_t s, unsigned long long* clk) {"),
    ("dH, dW, k,\n                                                 taus);",
     "dH, dW, k,\n                                                 taus, clk);"),
    ("int B, void* stream) {", "int B, void* stream, unsigned long long* clk) {"),
    ("k, t, B, s);", "k, t, B, s, clk);", "*"),
]

RESPONSE_EDITS = [
    ('#include "smem_once.cuh"', f'#include "smem_once.cuh"\n#define MARKS {MARKS}\n{_MARK}'),
    ("int H, W, y0, x0;  // image size, tile origin",
     "int H, W, y0, x0;  // image size, tile origin\n  unsigned long long* clk;"),
    ('asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();',
     'asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  phase_mark(t.clk, 1);'),
    ("      s_p[2 * RH * PW + o] = taps<7>(kG15r3, yy + i);\n    }\n  });\n  __syncthreads();",
     "      s_p[2 * RH * PW + o] = taps<7>(kG15r3, yy + i);\n    }\n  });\n  phase_mark(t.clk, 2);"),
    ("    store4(s_row + r * TW + c, m);\n  });\n  __syncthreads();",
     "    store4(s_row + r * TW + c, m);\n  });\n  phase_mark(t.clk, 4);"),
    ("      nms[o] = ctr >= m ? ctr : -INFINITY;\n    }\n  });\n}",
     "      nms[o] = ctr >= m ? ctr : -INFINITY;\n    }\n  });\n  phase_mark(t.clk, 5);\n}"),
    ("float* __restrict__ resp, int H, int W) {",
     "float* __restrict__ resp, int H, int W, unsigned long long* clk) {\n  phase_mark(clk, 0, false);"),
    ("(int)blockIdx.y * TH, (int)blockIdx.x * TW};", "(int)blockIdx.y * TH, (int)blockIdx.x * TW, clk};"),
    ("    __syncthreads();\n    nms_out<TH>(", "    phase_mark(t.clk, 3);\n    nms_out<TH>("),
    ("int B, int H, int W, cudaStream_t s) {", "int B, int H, int W, cudaStream_t s, unsigned long long* clk) {"),
    ("(img, nms, resp, H, W);", "(img, nms, resp, H, W, clk);"),
    ("int B, int H, int W,\n                cudaStream_t s) {",
     "int B, int H, int W,\n                cudaStream_t s, unsigned long long* clk) {"),
    ("(img, nms, resp, B, H, W, s);", "(img, nms, resp, B, H, W, s, clk);", "*"),
    ("int tile_rows, void* stream) {", "int tile_rows, void* stream, unsigned long long* clk) {"),
    ("(th, img, nms, resp, B, H, W, s);", "(th, img, nms, resp, B, H, W, s, clk);", "*"),
]
# Phase names by mark index.
FED_PHASES = ["entry", "stage"] + [f"{w}{j}" for j in (1, 2, 3) for w in ("along_y", "update")]
RESPONSE_PHASES = ["entry", "stage", "products", "response", "row max", "column max + store"]


def _fail(msg: str) -> None:
    print(f"torch_kernel_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def instrument(name: str, edits, out_dir: str) -> str:
    src = open(os.path.join(ROOT, "vislam_tpu_torch", "ops", "csrc", name + ".cu")).read()
    for anchor, new, *every in edits:
        n = src.count(anchor)
        if n == 0 or (n > 1 and not every):
            _fail(f"{name}.cu: {n} places for {anchor!r}; update the script to the source")
        src = src.replace(anchor, new)
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def build_all() -> dict:
    from vislam_tpu_torch.ops import build

    csrc = os.path.join(ROOT, "vislam_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(ROOT, "vislam_tpu_torch", "_build", "phases")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, edits in (("fed_evolve", FED_EDITS), ("response_nms", RESPONSE_EDITS)):
        src = instrument(name, edits, out_dir)
        lib = os.path.join(out_dir, name + ".so")
        jobs[name] = (lib, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I", csrc,
                                             "-o", lib, src], stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            _fail(f"nvcc failed on the instrumented {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(lib)
    i, p = ctypes.c_int, ctypes.c_void_p
    libs["fed_evolve"].fed_steps.argtypes = [p, i, i, i, i, p, i, i, i, i, p, p, i, i, p, p]
    libs["response_nms"].response_nms.argtypes = [i, p, p, p, i, i, i, i, p, p]
    return libs


def report(label: str, clk, names) -> None:
    """One launch's line from its blocks' (globaltimer, clock64) marks."""
    c = clk.cpu().numpy().astype(np.int64).reshape(-1, MARKS, 2)
    sm = c[:, MARKS - 1, 1]
    g, k = c[:, :, 0], c[:, :, 1]
    marks = [m for m in range(MARKS - 1) if (g[:, m] > 0).all()]
    last = marks[-1]
    ghz = float(np.median((k[:, last] - k[:, 0]) / np.maximum(g[:, last] - g[:, 0], 1)))
    span = (g[:, last].max() - g[:, 0].min()) / 1e3
    parts = []
    for a, b in zip(marks[:-1], marks[1:]):
        d = (k[:, b] - k[:, a]) / ghz / 1e3
        parts.append(f"{names[b]} {d.mean():.2f} / {d.max():.2f}")
    total = (k[:, last] - k[:, 0]) / ghz / 1e3
    print(f"phases {label}: {len(sm)} blocks, at most {np.bincount(sm).max()} on one SM; span "
          f"{span:.2f} us; block {total.mean():.2f} / {total.max():.2f} us; SM clock {ghz:.3f} GHz; "
          f"phase mean / max us: {'; '.join(parts)}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)
    libs = build_all()
    import vislam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.frontend.nonlinear import (contrast_factor, fed_tau_steps,
                                                     nonlinear_scale_space)
    from vislam_tpu_torch.frontend.pyramid import build_pyramid, gaussian_blur
    from vislam_tpu_torch.ops.fed_kernel import TILE, fed_schedule
    from vislam_tpu_torch.ops.harris_kernel import FAMILIES

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=3, n_landmarks=300, seed=0))
    img = torch.as_tensor(seq["images"][1]).to("cuda", torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    k = contrast_factor(img.to(torch.bfloat16)).reshape(1).contiguous()
    L = gaussian_blur(img.to(torch.bfloat16), 1.0).float().contiguous()[None]
    B, H, W = L.shape
    fed = libs["fed_evolve"].fed_steps
    for T in (0.78, 3.84):      # the nonlinear scale space's two cycles, n = 4 and 8
        taus = fed_tau_steps(T)
        for rep in range(2):
            src = L
            for j, ln in enumerate(fed_schedule(len(taus))):
                se, de = ln.src_ext, ln.dst_ext
                dst = torch.empty(B, H + 2 * de, W + 2 * de, device="cuda")
                blocks = B * -(-(H + 2 * de) // TILE[0]) * -(-(W + 2 * de) // TILE[1])
                clk = torch.zeros(blocks * 2 * MARKS, dtype=torch.int64, device="cuda")
                t = (ctypes.c_float * ln.steps)(*taus[ln.first:ln.first + ln.steps])
                err = fed(src.data_ptr(), -se, -se, H + 2 * se, W + 2 * se, dst.data_ptr(), -de,
                          -de, H + 2 * de, W + 2 * de, k.data_ptr(), t, ln.steps, B, stream,
                          clk.data_ptr())
                if err:
                    _fail(f"fed_steps: cudaError {err}")
                torch.cuda.synchronize()
                if rep:
                    report(f"fed_evolve n={len(taus)} launch {j} ({ln.steps} steps, image + "
                           f"{de} px)", clk, FED_PHASES)
                src = dst
    gauss = [lv.float().contiguous() for lv in build_pyramid(img.to(torch.bfloat16), 2)]
    nonlin = [lv.contiguous() for lv in nonlinear_scale_space(img.to(torch.bfloat16), 2)]
    fields = {"shi_tomasi": gauss, "harris": gauss, "dog": gauss, "hessian": nonlin,
              "fast": nonlin}
    rn = libs["response_nms"].response_nms
    for fam, levels in fields.items():
        for lv in levels:
            x = lv[None]
            _, h, w = x.shape
            # The most blocks any tile height gives (8 rows): room for every choice.
            clk = torch.zeros(-(-h // 8) * -(-w // 32) * 2 * MARKS, dtype=torch.int64,
                              device="cuda")
            resp, nms = torch.empty_like(x), torch.empty_like(x)
            for _ in range(2):
                clk.zero_()
                err = rn(FAMILIES.index(fam), x.data_ptr(), nms.data_ptr(), resp.data_ptr(), 1,
                         h, w, 0, stream, clk.data_ptr())
                if err:
                    _fail(f"response_nms {fam}: cudaError {err}")
            torch.cuda.synchronize()
            used = int((clk.view(-1, MARKS, 2)[:, 0, 0] > 0).sum())
            report(f"response_nms {fam} {h}x{w}", clk[:used * 2 * MARKS], RESPONSE_PHASES)


if __name__ == "__main__":
    main()

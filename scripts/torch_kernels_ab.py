"""Time this tree's response + NMS and FED kernels against another tree's on
one NVIDIA card, each through its own package's public functions.

    python3 scripts/torch_kernels_ab.py --other DIR

DIR holds another tree of the repository, for example a `git archive` of
the parent commit unpacked into a gitignored directory. Each tree runs in a
process of its own, which puts that tree first on `sys.path`, builds the
tree's kernels into its own `vislam_tpu_torch/_build/` and calls its
`response_nms(img, detector)` and `fed_evolve(L, k, taus)`: the API the
trees share, whatever their kernels' C interfaces. The processes run in
turns: other, this, this, other. Each holds every kernel against its
tree's plain twin first (chip_smoke.py's tolerances), then times it as the
replay of a CUDA graph that captured 100 calls (the device's time per
call) on the images chip_smoke.py uses: each response family on its two
levels (`_gradmag2` on the frame) and FED's 4- and 8-step cycles at
480x752. Prints the card, one line per kernel and shape, and a JSON
summary last. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cuda"


def _fail(msg: str) -> None:
    print(f"torch_kernels_ab: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def graph_us(fn, calls: int = 100, replays: int = 5) -> float:
    """Mean us of one call replayed from a CUDA graph that captured `calls`
    calls (chip_smoke.py's `_graph_ms`)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays) * 1e3


def time_tree(tree: str) -> dict:
    """The tree's kernels, each checked against its twin and then timed:
    label -> graph-replayed us per call."""
    sys.path.insert(0, tree)
    import torch

    import vislam_tpu_torch
    if not os.path.abspath(vislam_tpu_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        _fail(f"imported {vislam_tpu_torch.__file__}, not the package of {tree}")
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.frontend.nonlinear import (contrast_factor, fed_tau_steps,
                                                     nonlinear_scale_space)
    from vislam_tpu_torch.frontend.pyramid import build_pyramid, gaussian_blur
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve, fed_evolve_plain
    from vislam_tpu_torch.ops.harris_kernel import response_nms, response_nms_plain

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=3, n_landmarks=300, seed=0))
    img = torch.as_tensor(seq["images"][1]).to(DEV, torch.float32)
    gauss = [lv.float().contiguous() for lv in build_pyramid(img.to(torch.bfloat16), 2)]
    nonlin = [lv.contiguous() for lv in nonlinear_scale_space(img.to(torch.bfloat16), 2)]
    fields = {"shi_tomasi": gauss, "harris": gauss, "dog": gauss, "hessian": nonlin,
              "fast": nonlin, "_gradmag2": [img]}
    out = {}
    for fam, levels in fields.items():
        for lv in levels:
            label = f"response_nms {fam} {tuple(lv.shape)}"
            k_nms, k_resp = response_nms(lv, fam)
            p_nms, p_resp = response_nms_plain(lv, fam)
            err = (k_resp - p_resp).abs().max().item() / max(p_resp.abs().max().item(), 1.0)
            agree = 1.0 if k_nms is None else \
                (torch.isneginf(k_nms) == torch.isneginf(p_nms)).float().mean().item()
            if not err < 1e-4 or not agree > 0.999:
                _fail(f"{tree}: {label} disagrees with its twin: error / scale {err}, "
                      f"nms agreement {agree}")
            out[label] = graph_us(lambda lv=lv, fam=fam: response_nms(lv, fam))
    k = contrast_factor(img.to(torch.bfloat16))
    L = gaussian_blur(img.to(torch.bfloat16), 1.0).float().contiguous()
    for T in (0.78, 3.84):      # the nonlinear scale space's two cycles, n = 4 and 8
        taus = fed_tau_steps(T)
        label = f"fed_evolve n={len(taus)} {tuple(L.shape)}"
        got = fed_evolve(L, k, taus)
        err = (got - fed_evolve_plain(L[None], k.reshape(1), taus)[0]).abs().max().item()
        if not err < 1e-3:
            _fail(f"{tree}: {label} disagrees with its twin: max abs err {err}")
        out[label] = graph_us(lambda L=L, taus=taus: fed_evolve(L, k, taus))
        L = got.contiguous()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--tree", help="time only this tree, in this process (used by the turns)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if args.tree:
        print(json.dumps(time_tree(args.tree)), flush=True)
        return
    if not args.other or not os.path.isdir(os.path.join(args.other, "vislam_tpu_torch")):
        _fail(f"--other must name a tree of the repository, got {args.other!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    runs = []
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", trees[name]],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            _fail(f"timing the {name} tree failed:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {"card": card, "other": trees["other"], "us": {}}
    for label in runs[0]:
        turns = [r[label] for r in runs]
        o, t = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        summary["us"][label] = dict(other=o, this=t, ratio=t / o, turns=turns)
        print(f"ab {label}: graph other {o:.2f} us, this {t:.2f} us ({t / o:.3f}x; turns "
              f"{[round(v, 2) for v in turns]})", flush=True)
    # One frame's calls of each response family: its two levels.
    for fam in ("shi_tomasi", "harris", "dog", "hessian", "fast"):
        rows = [v for label, v in summary["us"].items() if label.startswith(f"response_nms {fam} ")]
        o, t = sum(r["other"] for r in rows), sum(r["this"] for r in rows)
        summary["us"][f"response_nms {fam} per frame"] = dict(other=o, this=t, ratio=t / o)
        print(f"ab response_nms {fam} per frame (two levels): other {o:.2f} us, this {t:.2f} us "
              f"({t / o:.3f}x)", flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

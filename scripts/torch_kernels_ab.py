"""Time this tree's response + NMS and FED kernels and RANSAC draws against
another tree's on one NVIDIA card, each through its own package's public
functions; or, with --paths, the default and slam paths' frames/s and
launches per frame.

    python3 scripts/torch_kernels_ab.py --other DIR
    python3 scripts/torch_kernels_ab.py --other DIR --paths [--frames 60] [--slam-frames 20]

DIR holds another tree of the repository, for example a `git archive` of
the parent commit unpacked into a gitignored directory. Each tree runs in a
process of its own, which puts that tree first on `sys.path` and builds the
tree's kernels into its own `vislam_tpu_torch/_build/`. The processes run
in turns: other, this, this, other. Only the API the trees share is
called, whatever their kernels' C interfaces.

Kernels (the default): each tree's `response_nms(img, detector)` and
`fed_evolve(L, k, taus)` are held against the tree's plain twins first
(chip_smoke.py's tolerances), then timed as the replay of a CUDA graph that
captured 100 calls (the device's time per call) on the images
chip_smoke.py uses: each response family on its two levels (`_gradmag2` on
the frame) and FED's 4- and 8-step cycles at 480x752. Then the RANSAC
draws as each tree's step makes them, from its frame key (seed 0, frame
3) and logits log(w + 1e-9) of a mask with ~40% valid matches: one frame's
main and rescue draws (2 x 2 x 512 indices over M = 768), the vision-only
essential draw (512 x 8) and the batched step's for 8 keys with 8 logits
rows (under torch.func.vmap). A tree with the categorical draw op
(`ops/threefry_kernel.py::draw_categorical`) launches it once per solve; an
older tree writes the Gumbel fields (`engine.draw_fields`, one launch) and
takes each solve's argmax(logits + field). Each call is held against the
tree's CPU twin (index for index); the summary also holds the indices of
the two trees equal.

Paths (--paths): chip_smoke.py's default path (`SystemConfig()`, GT scale)
and slam path (`vi_factors` and `refine_in_step`, GT-free) run
`run_sequence_scan` over the seed-0 synthetic sequence at 480x752 from its
true initial state, at seed 0: frames/s as the median of 3 timed runs after
a warm-up, then the device launches (kernels, copies, memsets) per frame
from torch.profiler over 2 frames (1 on the slam path), and among them the
draw kernels' (`threefry_gumbel_kernel` or `threefry_categorical_kernel`,
whichever the tree has).

Prints the card, one line per kernel and shape (per path and turn), and a
JSON summary last. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
    out.update(time_draws())
    return out


def _draw_calls(dev: str):
    """label -> a call that makes the tree's RANSAC draws on `dev` (see
    the module docstring), the indices as one int64 tensor."""
    import torch

    from vislam_tpu_torch.engine import batch_keys
    from vislam_tpu_torch.engine.engine import (ESSENTIAL_PATHS, MAIN_PATHS, RESCUE_PATHS,
                                                FrameKey, draw_fields)
    from vislam_tpu_torch.utils import prng
    try:
        from vislam_tpu_torch.ops.threefry_kernel import draw_categorical
    except ImportError:
        draw_categorical = None

    H, M, B = 512, 768, 8
    g = torch.Generator().manual_seed(0)
    logits = torch.log((torch.rand(B + 1, M, generator=g) < 0.4).float() + 1e-9).to(dev)
    base = prng.key_tensor(prng.prng_key(0), dev)
    index = torch.tensor(3, dtype=torch.int32, device=dev)
    keys8 = prng.key_tensor(batch_keys(0, B), dev)

    def frame(base, lg, lg_rescue):
        key = FrameKey(base, index)
        if draw_categorical is not None:
            return torch.cat([draw_categorical(key, MAIN_PATHS, lg, (H,)),
                              draw_categorical(key, RESCUE_PATHS, lg_rescue, (H,))])
        f = draw_fields(key, MAIN_PATHS + RESCUE_PATHS, (H, M))
        return torch.stack([torch.argmax((lg if k < 2 else lg_rescue) + f[k], dim=-1)
                            for k in range(4)])

    def essential():
        key = FrameKey(base, index)
        if draw_categorical is not None:
            return draw_categorical(key, ESSENTIAL_PATHS, logits[0], (H, 8))
        return torch.argmax(logits[0] + draw_fields(key, ESSENTIAL_PATHS, (H, 8, M)), dim=-1)

    return {
        f"draws frame (main + rescue, 2 x 2 x {H} of {M})":
            lambda: frame(base, logits[0], logits[1]),
        f"draws essential ({H} x 8 of {M})": essential,
        f"draws batch{B} (vmap, {B} keys and logits rows)":
            lambda: torch.func.vmap(frame, in_dims=(0, 0, None))(keys8, logits[:B], logits[B]),
    }


def time_draws() -> dict:
    """Each draw call held against the tree's CPU twin index for index, then
    graph-replayed; also each call's indices (to hold the trees equal)."""
    import hashlib

    out = {}
    cpu = _draw_calls("cpu")
    for label, fn in _draw_calls(DEV).items():
        got = fn()
        if not torch_equal(got.cpu(), cpu[label]()):
            _fail(f"{label}: the card's indices differ from the CPU twin's")
        out[label] = graph_us(fn)
        out[f"{label} indices"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    return out


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def run_paths(tree: str, frames: int, slam_frames: int) -> dict:
    """Each path's frames/s and launches per frame in this process, with
    `tree`'s package."""
    sys.path.insert(0, tree)
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    import vislam_tpu_torch
    if not os.path.abspath(vislam_tpu_torch.__file__).startswith(os.path.abspath(tree) + os.sep):
        _fail(f"imported {vislam_tpu_torch.__file__}, not the package of {tree}")
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.utils.config import SystemConfig

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=frames + 1, n_landmarks=300, seed=0))
    base = SystemConfig()
    slam = dataclasses.replace(base, backend=dataclasses.replace(
        base.backend, vi_factors=True, refine_in_step=True))
    out = {}
    for name, cfg, n, gt_scale, traced in (("default", base, frames, True, 2),
                                           ("slam", slam, slam_frames, False, 1)):
        eng = VIOEngine(seq["calib"], cfg, device=DEV)

        def init():
            return eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                                  v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

        inputs = make_sequence_inputs(seq, 1, 1 + n, use_gt_scale=gt_scale, device=DEV)

        def first(k):
            return inputs._replace(images=inputs.images[:k], imu=inputs.imu[:k],
                                   imu_dt=inputs.imu_dt[:k], gt_pos=inputs.gt_pos[:k])

        run_sequence_scan(eng, init(), first(3))          # first use
        fps = []
        for _ in range(3):
            state0 = init()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_sequence_scan(eng, state0, inputs)
            torch.cuda.synchronize()
            fps.append(n / (time.perf_counter() - t0))
        state0 = init()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_sequence_scan(eng, state0, first(traced))
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        draws = sum(1 for e in events if "threefry_gumbel_kernel" in e.name
                    or "threefry_categorical_kernel" in e.name)
        out[name] = dict(frames=n, fps=sorted(fps)[1], fps_runs=fps,
                         launches_per_frame=len(events) / traced,
                         draw_kernel_per_frame=draws / traced)
    return out


def summarize_kernels(card: str, trees: dict, runs: list) -> dict:
    """Each kernel call's graph time per tree, the mean of its two turns."""
    summary = {"card": card, "other": trees["other"], "us": {}}
    for label in [k for k in runs[0] if k.endswith(" indices")]:
        same = len({r.get(label) for r in runs}) == 1
        summary[label] = same
        print(f"ab {label} equal in both trees: {same}", flush=True)
        if not same:
            _fail(f"{label} differ between the trees")
    for label in [k for k in runs[0] if not k.endswith(" indices")]:
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
    return summary


def summarize_paths(card: str, trees: dict, runs: list) -> dict:
    """Each path's frames/s and launches per frame per tree, the mean of its
    two turns."""
    summary = {"card": card, "other": trees["other"], "paths": {}}
    for path in runs[0]:
        turns = [r[path] for r in runs]
        side = {"other": (turns[0], turns[3]), "this": (turns[1], turns[2])}
        summary["paths"][path] = {
            who: dict(fps=sum(t["fps"] for t in ts) / 2,
                      launches_per_frame=sum(t["launches_per_frame"] for t in ts) / 2)
            for who, ts in side.items()}
        s = summary["paths"][path]
        print(f"ab {path}: frames/s other {s['other']['fps']:.2f}, this {s['this']['fps']:.2f} "
              f"({s['this']['fps'] / s['other']['fps']:.3f}x); launches per frame other "
              f"{s['other']['launches_per_frame']:.1f}, this "
              f"{s['this']['launches_per_frame']:.1f}", flush=True)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--tree", help="run only this tree, in this process (used by the turns)")
    ap.add_argument("--paths", action="store_true",
                    help="compare the default and slam paths, not the kernels")
    ap.add_argument("--frames", type=int, default=60, help="--paths: frames of the default path")
    ap.add_argument("--slam-frames", type=int, default=20, help="--paths: frames of the slam path")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    if args.tree:
        out = (run_paths(args.tree, args.frames, args.slam_frames) if args.paths
               else time_tree(args.tree))
        print(json.dumps(out), flush=True)
        return
    if not args.other or not os.path.isdir(os.path.join(args.other, "vislam_tpu_torch")):
        _fail(f"--other must name a tree of the repository, got {args.other!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    mode = (["--paths", "--frames", str(args.frames), "--slam-frames", str(args.slam_frames)]
            if args.paths else [])
    runs = []
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", trees[name],
                               *mode], capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            _fail(f"the {name} tree failed:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        if args.paths:
            for path, r in runs[-1].items():
                print(f"ab {name} {path}: {r['frames']} frames, {r['fps']:.2f} frames/s (median "
                      f"of {[round(f, 2) for f in r['fps_runs']]}), "
                      f"{r['launches_per_frame']:.1f} launches per frame, "
                      f"{r['draw_kernel_per_frame']:.1f} of the draw kernel", flush=True)
    summarize = summarize_paths if args.paths else summarize_kernels
    print(json.dumps(summarize(card, trees, runs)), flush=True)

if __name__ == "__main__":
    main()

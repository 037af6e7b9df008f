"""Time the port CLI's pipelined host loop against `run_sequence_scan` on
one NVIDIA card, in one process, in interleaved rounds.

    python3 scripts/torch_host_loop.py [--rounds 10] [--frames 61]

Every round runs four variants on the synthetic sequence the CLI makes
for `--synthetic FRAMES` (seed 0, 480x752):

- scan: `run_sequence_scan` from the initial state, the inputs already on
  the card, ended by a synchronise (as chip_smoke.py's phase cli a);
- loop: the CLI's `main(["--synthetic", FRAMES])` as users run it
  (`step_pipelined` per frame, a fetch every `cli.PIPE_BURST` frames), the
  wall time of its loop;
- pageable: the same loop with `VIOEngine._pinned` bypassed, so each
  frame's small vectors are copied to the card from pageable memory;
- burst1: the same loop with `cli.PIPE_BURST = 1`, a fetch every frame.

The order within a round rotates by one each round, so no variant always
follows another. Each loop variant's rows must equal the loop's
(keyframes equal, positions within 1e-5 m). Beside the wall time, each
loop variant's two host waits are timed on their own, which the host's
spread hides in the wall time: the host ms per call of
`VIOEngine._upload` (a frame's copies to the card; from pageable memory
CUDA may first wait for the stream's queued work), every call of the
run; and the drain (the fetch of a burst's results) per fetch and per
frame. Prints the card, ms per frame per round, and for each variant its
difference from the scan and from the loop in the same round (median,
range, rounds above 0), then a JSON summary last. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vislam_tpu_torch import cli  # noqa: E402
from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence  # noqa: E402
from vislam_tpu_torch.engine import (  # noqa: E402
    VIOEngine, make_sequence_inputs, run_sequence_scan,
)
from vislam_tpu_torch.ops import build  # noqa: E402
from vislam_tpu_torch.utils.config import SystemConfig  # noqa: E402

VARIANTS = ("scan", "loop", "pageable", "burst1")


def _fail(msg: str) -> None:
    print(f"torch_host_loop: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _stats(xs) -> dict:
    xs = np.asarray(xs, np.float64)
    return dict(median=float(np.median(xs)), min=float(xs.min()), max=float(xs.max()),
                above_0=int((xs > 0).sum()), n=int(xs.size))


def _run_cli(frames: int, tmp: str, name: str) -> dict:
    """One CLI run in this process (its printing kept out of the output),
    its `VIOEngine._upload` calls timed: report["upload_ms"], host ms per
    call."""
    upload = VIOEngine._upload
    spent = [0.0, 0]

    def timed(self, *args):
        t0 = time.perf_counter()
        out = upload(self, *args)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    report = {}
    VIOEngine._upload = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--synthetic", str(frames), "--output",
                           os.path.join(tmp, f"{name}.csv")], report=report)
    finally:
        VIOEngine._upload = upload
    if rc != 0:
        _fail(f"{name}: exit status {rc}")
    report["upload_ms"] = 1e3 * spent[0] / spent[1]
    return report


def _rows_equal(name: str, a: list, b: list) -> None:
    if [r["frame"] for r in a] != [r["frame"] for r in b] or \
            [r["is_kf"] for r in a] != [r["is_kf"] for r in b]:
        _fail(f"{name}: frames or keyframes differ from the loop's")
    dp = float(np.abs(np.array([r["est_p"] for r in a], np.float64)
                      - np.array([r["est_p"] for r in b], np.float64)).max())
    if not dp <= 1e-5:
        _fail(f"{name}: positions differ from the loop's by {dp} m")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--frames", type=int, default=61)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this probe needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    build.build_all(build.SOURCES)

    frames, n = args.frames, args.frames - 1
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=frames, n_landmarks=300, seed=0))
    eng = VIOEngine(seq["calib"], SystemConfig(), device="cuda")
    inputs = make_sequence_inputs(seq, 1, frames, device="cuda")

    def init():
        return eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                              v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

    def scan(tmp, name):
        st0 = init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_sequence_scan(eng, st0, inputs)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, None

    def loop(tmp, name):
        rep = _run_cli(frames, tmp, name)
        t = rep["timer"]
        waits[name.split("_")[0]].append(dict(
            upload_ms=rep["upload_ms"],
            drain_ms_per_fetch=1e3 * t.total["drain"] / t.count["drain"],
            drain_ms_per_frame=1e3 * t.total["drain"] / rep["frames"]))
        return 1e3 * rep["wall"] / rep["frames"], rep["rows"]

    def pageable(tmp, name):
        pinned = VIOEngine._pinned
        VIOEngine._pinned = lambda self, t: t
        try:
            return loop(tmp, name)
        finally:
            VIOEngine._pinned = pinned

    def burst1(tmp, name):
        burst = cli.PIPE_BURST
        cli.PIPE_BURST = 1
        try:
            return loop(tmp, name)
        finally:
            cli.PIPE_BURST = burst

    fns = dict(scan=scan, loop=loop, pageable=pageable, burst1=burst1)
    ms = {v: [] for v in VARIANTS}
    waits = {v: [] for v in VARIANTS[1:]}
    tmp = tempfile.mkdtemp(prefix="torch_host_loop_")
    try:
        for v in VARIANTS:                     # warm-up: builds, loads, allocator
            fns[v](tmp, f"{v}_warm")
        for w in waits.values():
            w.clear()
        ref_rows = None
        for r in range(args.rounds):
            order = VARIANTS[r % 4:] + VARIANTS[:r % 4]
            rows = {}
            for v in order:
                t, rows[v] = fns[v](tmp, f"{v}_{r}")
                ms[v].append(t)
            ref_rows = ref_rows or rows["loop"]
            for v in ("loop", "pageable", "burst1"):
                _rows_equal(f"{v} round {r}", rows[v], ref_rows)
            print(f"round {r} ({' '.join(order)}): "
                  + ", ".join(f"{v} {ms[v][-1]:.3f}" for v in VARIANTS) + " ms per frame",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    summary = dict(card=card, frames=n, rounds=args.rounds, pipe_burst=cli.PIPE_BURST,
                   ms_per_frame={v: _stats(ms[v]) for v in VARIANTS})
    ms_np = {v: np.asarray(ms[v]) for v in VARIANTS}
    summary["minus_scan"] = {v: _stats(ms_np[v] - ms_np["scan"]) for v in VARIANTS[1:]}
    summary["minus_loop"] = {v: _stats(ms_np[v] - ms_np["loop"]) for v in VARIANTS[2:]}
    for v in VARIANTS:
        s = summary["ms_per_frame"][v]
        print(f"{v}: ms per frame median {s['median']:.3f} (range {s['min']:.3f}-"
              f"{s['max']:.3f}), frames/s {1e3 / s['median']:.2f}", flush=True)
    summary["host_waits"] = {v: {k: _stats([w[k] for w in ws]) for k in ws[0]}
                             for v, ws in waits.items()}
    for v, ws in summary["host_waits"].items():
        print(f"{v}: " + "; ".join(
            f"{k} median {s['median']:.4f} (range {s['min']:.4f}-{s['max']:.4f})"
            for k, s in ws.items()), flush=True)
    for base in ("scan", "loop"):
        for v, s in summary[f"minus_{base}"].items():
            print(f"{v} - {base}, paired by round: median {s['median']:+.3f} ms per frame "
                  f"(range {s['min']:+.3f} to {s['max']:+.3f}; above 0 in {s['above_0']} of "
                  f"{s['n']})", flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()

"""The JAX package's rows of EVAL configs 1, 2c and 6 on the CPU, and their
spread under a 1-ulp change of the inputs or another RANSAC stream: the
reference values and bounds that `scripts/torch_eval_configs.py` holds the
port's card runs to.

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 1
        [--vary ulp|seed] [--branch cpu|tpu] [--draws 4] [--first 0] [--out FILE]

Each config runs `scripts/eval_configs.py`'s own `run_vio` (config 1),
`run_cold` (2c) or `run_long` (6) on its pinned sequence (`PINNED`), once
as generated (draw 0) and once per further draw d. With `--vary ulp` draw
d moves every IMU sample (gyro and accelerometer, float32) by one ulp up
or down at random (`numpy.random.default_rng(d)`); the images are not
perturbed, since the default pipeline runs them in bfloat16, where a
float32 ulp rounds away. With `--vary seed` draw d runs the engine with
RANSAC seed d (`VIOEngine(..., seed=d)`): the port draws its hypotheses
from a stream of its own, so the reference's spread over streams is the
part of the difference the draws make. `--branch tpu` computes every
detector response in float32 from the bfloat16 pyramid, the arithmetic of
the reference's TPU branch (`frontend/detect.py`: the Pallas kernel takes
the level cast to float32), which the port implements; the default `cpu`
runs the reference's CPU branch (the response in the pyramid's bfloat16).
Prints each draw's row as it ends
and then one JSON object with every draw's row and, per metric, the
largest distance of a further draw from draw 0 (the spread).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# config: (SyntheticConfig arguments, the row's metrics)
CONFIGS = {
    "1": (dict(n_frames=80, n_landmarks=300, seed=0), ("ate",)),
    "2c": (dict(n_frames=60, n_landmarks=300, seed=0), ("ate_live", "ate_smoothed")),
    "6": (dict(n_frames=500, n_landmarks=400, seed=42),
          ("ate_full", "ate_f1_100", "ate_f100_300", "ate_f300_500", "kf_maxerr_before",
           "kf_maxerr_after")),
}


def perturbed(seq, draw: int):
    """seq with its IMU samples moved by one float32 ulp (draw > 0)."""
    if draw == 0:
        return seq
    rng = np.random.default_rng(draw)
    out = dict(seq)
    for k in ("imu_gyro", "imu_accel"):
        x = np.asarray(seq[k], np.float32)
        away = np.where(rng.random(x.shape) < 0.5, np.float32(-np.inf), np.float32(np.inf))
        out[k] = np.nextafter(x, away.astype(np.float32))
    return out


def seeded(seed: int):
    """The reference's VIOEngine made with RANSAC seed `seed` wherever the
    harness makes one (it imports the class at call time)."""
    import vislam_tpu.engine as je

    je.VIOEngine = functools.partial(getattr(je.VIOEngine, "func", je.VIOEngine), seed=seed)


def tpu_branch():
    """Every detector response of the reference computed in float32 from
    its (bfloat16) pyramid level, as its TPU branch's kernel computes it."""
    import jax.numpy as jnp

    import vislam_tpu.frontend.detect as jd

    for name, fn in list(jd.DETECTOR_RESPONSES.items()):
        jd.DETECTOR_RESPONSES[name] = functools.partial(
            lambda img, fn: fn(img.astype(jnp.float32)), fn=fn)


def run_config(name: str, seq) -> dict:
    import eval_configs as ec
    from vislam_tpu.eval import ate_rmse

    if name == "1":
        r = ec.run_vio(seq, gt_scale=True)
        return {"ate": float(ate_rmse(r["poses"], r["gt"], align=False))}
    if name == "2c":
        return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in ec.run_cold(seq).items()}
    r = ec.run_long(seq)
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v) for k, v in r.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--vary", default="ulp", choices=["ulp", "seed"])
    ap.add_argument("--branch", default="cpu", choices=["cpu", "tpu"])
    ap.add_argument("--draws", type=int, default=4, help="draws in all, draw 0 included")
    ap.add_argument("--first", type=int, default=0, help="first draw")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

    if args.branch == "tpu":
        tpu_branch()
    kw, metrics = CONFIGS[args.config]
    seq = make_synthetic_sequence(SyntheticConfig(**kw))
    rows = {}
    for d in range(args.first, args.first + args.draws):
        t0 = time.perf_counter()
        if args.vary == "seed":
            seeded(d)
            rows[d] = run_config(args.config, seq)
        else:
            rows[d] = run_config(args.config, perturbed(seq, d))
        print(f"config {args.config} draw {d}: {rows[d]} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    out = {"config": args.config, "vary": args.vary, "branch": args.branch, "rows": rows}
    if 0 in rows and len(rows) > 1:
        out["spread"] = {m: max(abs(r[m] - rows[0][m]) for d, r in rows.items() if d)
                         for m in metrics if m in rows[0]}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()

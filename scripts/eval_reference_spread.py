"""The JAX package's rows of EVAL configs 1, 2, 2c, 3, 4, 5 and 6 on the CPU, and their
spread under a 1-ulp change of the inputs or another RANSAC stream: the
reference values and bounds that `scripts/torch_eval_configs.py` holds the
port's card runs to.

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 1
        [--vary ulp|seed] [--branch cpu|tpu] [--draws 4] [--first 0] [--out FILE]

Each config runs `scripts/eval_configs.py`'s own `run_vio` (configs 1, 2,
3 and 4, with the options its `main()` gives each row), `run_cold` (2c) or
`run_long` (6) on its pinned sequence (`PINNED`); config 5, inline in that
`main()`, is repeated by `run_batch` here. Each runs once as generated
(draw 0) and once per further draw d. With `--vary ulp` draw
d moves every IMU sample (gyro and accelerometer, float32) by one ulp up
or down at random (`numpy.random.default_rng(d)`); the images are not
perturbed, since the default pipeline runs them in bfloat16, where a
float32 ulp rounds away. With `--vary seed` draw d runs the engine with
RANSAC seed d (`VIOEngine(..., seed=d)`; config 5: `run_batch_scan(...,
seed=d)`): the port draws its hypotheses
from a stream of its own, so the reference's spread over streams is the
part of the difference the draws make. `--branch tpu` computes every
detector response in float32 from the bfloat16 pyramid, the arithmetic of
the reference's TPU branch (`frontend/detect.py`: the Pallas kernel takes
the level cast to float32), which the port implements; the default `cpu`
runs the reference's CPU branch (the response in the pyramid's bfloat16).
Prints each draw's row as it ends
and then one JSON object with every draw's row and, per metric, the
largest distance of a further draw from draw 0 (the spread).

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 3
        --locate-marg --branch tpu --draws 1 [--first d]

locates where the port's row 3b `marg` parts from the reference's at each
RANSAC seed d (both draw the same hypotheses since the port copies JAX's
stream): the reference's run, the reference's run with its IMU samples
moved by one ulp (draw 1's perturbation) and the port's run on the CPU
(`scripts/torch_eval_configs.py`'s runner), frame by frame: the first
frame where each pair's positions part by more than 1e-6 m and by more
than 1e-4 m, the keyframes refined by then, the largest gap, each ATE.
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

# config: (SyntheticConfig arguments, the row's metrics); config 5 steps
# eight sequences, seeds 0-7 (its "seed" is replaced by each)
CONFIGS = {
    "1": (dict(n_frames=80, n_landmarks=300, seed=0), ("ate",)),
    "2": (dict(n_frames=80, n_landmarks=300, seed=0),
          ("ate", "scale_ratio", "ate_vi_ba", "scale_ratio_vi_ba", "ate_open_unsupervised")),
    "2c": (dict(n_frames=60, n_landmarks=300, seed=0), ("ate_live", "ate_smoothed")),
    "3": (dict(n_frames=60, n_landmarks=350, seed=1, trans_amp=(2.0, 1.4, 0.7),
               rot_amp=(0.12, 0.15, 0.3)),
          ("ate_plain", "ate_photometric", "ate_online_ba", "ate_vi_open_loop",
           "ate_vi_online_ba_ends", "ate_vi_online_ba_marg")),
    "4": (dict(n_frames=86, n_landmarks=300, seed=21),
          ("ate_open_loop", "n_loops", "kf_maxerr_before", "kf_maxerr_after")),
    "5": (dict(n_frames=24, n_landmarks=250, seed=0), ("ate_mean", "ate_max")),
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


def _path_length(p) -> float:
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def _with(**sections):
    """SystemConfig() with the given sections' fields replaced."""
    import dataclasses

    from vislam_tpu.utils.config import SystemConfig

    c = SystemConfig()
    return dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), **v)
                                     for k, v in sections.items()})


def run_batch(seqs, seed: int = 0, cfg=None) -> dict:
    """Config 5 as `scripts/eval_configs.py`'s main() runs it: run_batch_scan
    over the sequences from their true initial states (cfg: the engine's,
    SystemConfig() by default), ATE per entry."""
    import jax
    import jax.numpy as jnp

    from vislam_tpu.engine import VIOEngine, make_sequence_inputs, run_batch_scan
    from vislam_tpu.eval import ate_rmse
    from vislam_tpu.utils.config import SystemConfig

    n = len(seqs[0]["images"])
    eng = VIOEngine(seqs[0]["calib"], cfg or SystemConfig())
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0], v_w0=s["gt_vel"][0],
                       p_w0=s["gt_pos"][0]) for s in seqs])
    inps = [make_sequence_inputs(s) for s in seqs]
    inputs = jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *inps)
    kf0 = jnp.stack([jnp.asarray(s["gt_pos"][0], jnp.float32) for s in seqs])
    _, res = run_batch_scan(eng, states, inputs, kf0, seed=seed)
    ates = [float(ate_rmse(np.asarray(res.p_wc[b]), s["gt_pos"][1:n], align=False))
            for b, s in enumerate(seqs)]
    return {"ate_mean": float(np.mean(ates)), "ate_max": float(np.max(ates)), "ates": ates,
            "poses": np.asarray(res.p_wc)}


def run_config(name: str, seq, seed: int = 0) -> dict:
    """Config `name`'s row on seq (config 5: a list of sequences)."""
    import eval_configs as ec
    from vislam_tpu.eval import ate_rmse

    def ate(r):
        return float(ate_rmse(r["poses"], r["gt"], align=False))

    if name == "1":
        r = ec.run_vio(seq, gt_scale=True)
        return {"ate": ate(r)}
    if name == "2":
        r = ec.run_vio(seq, gt_scale=False)
        r_vb = ec.run_vio(seq, gt_scale=False, vi_ba=True)
        r_un = ec.run_vio(seq, cfg=_with(engine=dict(vi_align_bootstrap=False)),
                          gt_scale=False)
        gl = _path_length(r["gt"])
        return {"ate": ate(r), "scale_ratio": _path_length(r["poses"]) / gl,
                "ate_vi_ba": ate(r_vb), "scale_ratio_vi_ba": _path_length(r_vb["poses"]) / gl,
                "ate_open_unsupervised": ate(r_un)}
    if name == "3":
        return {
            "ate_plain": ate(ec.run_vio(seq, gt_scale=True)),
            "ate_photometric": ate(ec.run_vio(seq, gt_scale=True, photometric=True)),
            "ate_online_ba": ate(ec.run_vio(seq, gt_scale=True, ba=True)),
            "ate_vi_open_loop": ate(ec.run_vio(seq, gt_scale=False)),
            "ate_vi_online_ba_ends": ate(ec.run_vio(seq, gt_scale=False, vi_ba=True)),
            "ate_vi_online_ba_marg": ate(ec.run_vio(
                seq, cfg=_with(backend=dict(online_gauge="marg")), gt_scale=False,
                vi_ba=True)),
        }
    if name == "4":
        r = ec.run_vio(seq, gt_scale=True, loop_correct=True)
        return {"ate_open_loop": ate(r), "n_loops": len(r.get("loops", [])),
                "kf_maxerr_before": r.get("kf_err_before"),
                "kf_maxerr_after": r.get("kf_err_after")}
    if name == "5":
        r = run_batch(seq, seed)
        r.pop("poses")
        return r
    if name == "2c":
        return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in ec.run_cold(seq).items()}
    r = ec.run_long(seq)
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v) for k, v in r.items()}


def _first_apart(a, b, tol: float):
    """The first frame (1-based) where poses a and b (N, 3) part by more
    than tol (max norm), or None."""
    far = np.nonzero(np.abs(np.asarray(a) - np.asarray(b)).max(-1) > tol)[0]
    return int(far[0]) + 1 if len(far) else None


def locate_marg(seed: int) -> dict:
    """Config 3b's marg row at RANSAC seed `seed`: the reference, the
    reference under a 1-ulp IMU change, and the port on the CPU, frame by
    frame (see the module docstring)."""
    import eval_configs as ec
    import torch_eval_configs as tc
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu.eval import ate_rmse
    from vislam_tpu_torch.data import make_synthetic_sequence as port_sequence
    from vislam_tpu_torch.data import SyntheticConfig as PortConfig

    kw = CONFIGS["3"][0]
    seq = make_synthetic_sequence(SyntheticConfig(**kw))
    seeded(seed)
    marg = _with(backend=dict(online_gauge="marg"))
    runs = {"reference": ec.run_vio(seq, cfg=marg, gt_scale=False, vi_ba=True)["poses"],
            "reference, 1 ulp": ec.run_vio(perturbed(seq, 1), cfg=marg, gt_scale=False,
                                           vi_ba=True)["poses"]}
    port = tc._vio(port_sequence(PortConfig(**kw)), "cpu", seed,
                   tc._with(backend=dict(online_gauge="marg")), gt_scale=False, vi_ba=True)
    runs["port (CPU)"] = port["poses"]
    gt = seq["gt_pos"][1:len(seq["images"])]
    out = {"seed": seed, "ate": {k: float(ate_rmse(v, gt, align=False)) for k, v in runs.items()}}
    ref = runs["reference"]
    for name in ("reference, 1 ulp", "port (CPU)"):
        p = runs[name]
        out[name] = dict(apart_1e6=_first_apart(p, ref, 1e-6), apart_1e4=_first_apart(p, ref, 1e-4),
                         max_dp=float(np.abs(p - ref).max()))
        print(f"config 3b marg seed {seed}: {name} against the reference: positions part "
              f"(> 1e-6 m) first at frame {out[name]['apart_1e6']}, (> 1e-4 m) at frame "
              f"{out[name]['apart_1e4']}; largest |dp| {out[name]['max_dp']:.3e} m; ATE "
              f"{out['ate'][name]:.6f} against {out['ate']['reference']:.6f} m", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, choices=sorted(CONFIGS))
    ap.add_argument("--vary", default="ulp", choices=["ulp", "seed"])
    ap.add_argument("--branch", default="cpu", choices=["cpu", "tpu"])
    ap.add_argument("--draws", type=int, default=4, help="draws in all, draw 0 included")
    ap.add_argument("--first", type=int, default=0, help="first draw")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--locate-marg", action="store_true",
                    help="config 3: locate where the port's marg row parts from the reference's")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

    if args.branch == "tpu":
        tpu_branch()
    if args.locate_marg:
        out = [locate_marg(d) for d in range(args.first, args.first + args.draws)]
        print(json.dumps(out))
        return
    kw, metrics = CONFIGS[args.config]
    if args.config == "5":
        seq = [make_synthetic_sequence(SyntheticConfig(**{**kw, "seed": s})) for s in range(8)]
    else:
        seq = make_synthetic_sequence(SyntheticConfig(**kw))
    rows = {}
    for d in range(args.first, args.first + args.draws):
        t0 = time.perf_counter()
        if args.vary == "seed":
            seeded(d)
            rows[d] = run_config(args.config, seq, seed=d)
        elif args.config == "5":
            rows[d] = run_config(args.config, [perturbed(s, d) for s in seq])
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

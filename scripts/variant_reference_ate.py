"""The JAX package's ATE on the step options of `chip_smoke.py`'s phase
variants and on EVAL.md's configs 2, 3 and 3b (and, on request, 6), on
the CPU.

    JAX_PLATFORMS=cpu python scripts/variant_reference_ate.py [--out FILE]
        [--eval-only] [--config6]

Each variant path runs the reference engine (`vislam_tpu`) on the sequence,
configuration and number of frames that phase variants drives the port
with, from the true initial state, GT scale or GT-free as the path says,
and reports its unaligned ATE the way chip_smoke.py reports a path's (the
true first position, then each frame's). The batched path runs the
reference's `run_batch_scan` and reports each entry's. EVAL config 3's
plain, +photometric and marg-gauge rows come from `scripts/eval_configs.py`'s
own `run_vio` on config 3's pinned sequence (its ATE over frames 1-59),
as do config 2's rows (open loop, +VI-BA, on its pinned 80-frame sequence)
and config 3b's open-loop and `ends` rows; `--config6` adds config 6's
500-frame run (`run_long`); `--eval-only` skips the variant paths.
Prints one JSON object; these are the reference values chip_smoke.py prints
beside the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {
    # name: (sequence, frames, GT scale, frontend, backend, engine)
    "oriented": ("seq0", 30, True, dict(oriented=True), {}, {}),
    "gated": ("seq0", 30, True, dict(guided_gate_px=30.0), {}, {}),
    "photometric": ("seq3", 59, True, {}, {}, dict(photometric_refine=True)),
    "marg": ("seq3", 34, False, {},
             dict(vi_factors=True, refine_in_step=True, online_gauge="marg"), {}),
    "oldest2": ("seq0", 12, True, {}, dict(refine_in_step=True, online_gauge="oldest2"), {}),
}
BATCH_VISION = (4, 20)   # sequences (seeds 0 to 3), frames


def sequences():
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

    return {
        "seq0": make_synthetic_sequence(SyntheticConfig(n_frames=61, n_landmarks=300, seed=0)),
        # EVAL config 3 (scripts/eval_configs.py, pinned).
        "seq3": make_synthetic_sequence(SyntheticConfig(
            n_frames=60, n_landmarks=350, seed=1,
            trans_amp=(2.0, 1.4, 0.7), rot_amp=(0.12, 0.15, 0.3))),
    }


def _cfg(frontend, backend, engine):
    from vislam_tpu.utils.config import SystemConfig

    c = SystemConfig()
    return dataclasses.replace(
        c, frontend=dataclasses.replace(c.frontend, **frontend),
        backend=dataclasses.replace(c.backend, **backend),
        engine=dataclasses.replace(c.engine, **engine))


def run_path(seq, n, gt_scale, cfg):
    from vislam_tpu.engine import VIOEngine
    from vislam_tpu.eval import ate_rmse

    eng = VIOEngine(seq["calib"], cfg)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                           v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
    last_kf, poses, kfs = 0, [seq["gt_pos"][0]], 0
    for j in range(1, n + 1):
        imu = np.zeros((16, 6), np.float32)
        imu[:10] = np.concatenate([seq["imu_gyro"][(j - 1) * 10:j * 10],
                                   seq["imu_accel"][(j - 1) * 10:j * 10]], -1)
        dt = np.zeros(16, np.float32)
        dt[:10] = 1 / 200.0
        g = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf])) \
            if gt_scale else -1.0
        state, res = eng.step(state, seq["images"][j], imu, dt, g)
        if bool(res.is_keyframe):
            last_kf, kfs = j, kfs + 1
        poses.append(np.asarray(res.p_wc))
    return float(ate_rmse(np.array(poses), seq["gt_pos"][:n + 1], align=False)), kfs


def run_batch_vision(B, n):
    import jax
    import jax.numpy as jnp

    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu.engine import VIOEngine, make_sequence_inputs, run_batch_scan
    from vislam_tpu.eval import ate_rmse

    seqs = [make_synthetic_sequence(SyntheticConfig(n_frames=n + 1, n_landmarks=300, seed=s))
            for s in range(B)]
    cfg = _cfg(dict(levels_used=1), {}, dict(vision_rotation=True))
    eng = VIOEngine(seqs[0]["calib"], cfg)
    states = [eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0], v_w0=s["gt_vel"][0],
                             p_w0=s["gt_pos"][0]) for s in seqs]
    ins = [make_sequence_inputs(s) for s in seqs]
    _, res = run_batch_scan(
        eng, jax.tree.map(lambda *xs: jnp.stack(xs), *states),
        jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *ins),
        jnp.asarray(np.stack([s["gt_pos"][0] for s in seqs]), jnp.float32))
    p = np.asarray(res.p_wc)
    return [float(ate_rmse(np.concatenate([s["gt_pos"][:1], p[b]]), s["gt_pos"][:n + 1],
                           align=False)) for b, s in enumerate(seqs)]


def eval_config3(seq3):
    """EVAL config 3's rows 3 (plain, +photometric) and 3b (marg gauge),
    by scripts/eval_configs.py's run_vio, as its main() runs them."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eval_configs import run_vio

    from vislam_tpu.eval import ate_rmse
    from vislam_tpu.utils.config import SystemConfig

    out = {}
    r = run_vio(seq3, gt_scale=True)
    out["3_plain"] = float(ate_rmse(r["poses"], r["gt"], align=False))
    r = run_vio(seq3, gt_scale=True, photometric=True)
    out["3_photometric"] = float(ate_rmse(r["poses"], r["gt"], align=False))
    c = SystemConfig()
    c = dataclasses.replace(c, backend=dataclasses.replace(c.backend, online_gauge="marg"))
    r = run_vio(seq3, cfg=c, gt_scale=False, vi_ba=True)
    out["3b_marg"] = float(ate_rmse(r["poses"], r["gt"], align=False))
    r = run_vio(seq3, gt_scale=False)
    out["3b_open_loop"] = float(ate_rmse(r["poses"], r["gt"], align=False))
    r = run_vio(seq3, gt_scale=False, vi_ba=True)
    out["3b_ends"] = float(ate_rmse(r["poses"], r["gt"], align=False))
    return out


def eval_config2():
    """EVAL config 2's rows (open loop, +VI-BA, each with its path-length
    scale ratio) on its pinned sequence (seed 0, 80 frames, 300
    landmarks), by run_vio as scripts/eval_configs.py's main() runs them."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eval_configs import run_vio

    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu.eval import ate_rmse

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=80, n_landmarks=300, seed=0))
    out = {}
    for name, vi_ba in (("2_open_loop", False), ("2_vi_ba", True)):
        r = run_vio(seq, gt_scale=False, vi_ba=vi_ba)
        length = np.linalg.norm(np.diff(r["poses"], axis=0), axis=1).sum()
        gt_length = np.linalg.norm(np.diff(r["gt"], axis=0), axis=1).sum()
        out[name] = {"ate": float(ate_rmse(r["poses"], r["gt"], align=False)),
                     "scale_ratio": float(length / gt_length)}
    return out


def eval_config6():
    """EVAL config 6's 500-frame GT-free VI-BA run (scripts/eval_configs.py
    run_long on its pinned sequence)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eval_configs import run_long

    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=500, n_landmarks=400, seed=42))
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
            for k, v in run_long(seq).items() if k != "fps_cpu_harness"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--eval-only", action="store_true",
                    help="only EVAL.md's rows, not the variant paths")
    ap.add_argument("--config6", action="store_true",
                    help="also EVAL config 6's 500-frame run")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    seqs = sequences()
    out = {}
    for name, (sq, n, gt, fe, be, en) in ({} if args.eval_only else VARIANTS).items():
        t0 = time.perf_counter()
        ate, kfs = run_path(seqs[sq], n, gt, _cfg(fe, be, en))
        out[name] = {"ate": ate, "keyframes": kfs, "frames": n, "sequence": sq}
        print(f"{name}: ATE {ate:.4f} m, {kfs} keyframes, {n} frames "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    if not args.eval_only:
        out["batch_vision"] = {"ate": run_batch_vision(*BATCH_VISION),
                               "sequences": BATCH_VISION[0], "frames": BATCH_VISION[1]}
        print(f"batch_vision: {out['batch_vision']}", flush=True)
    out["eval_config2"] = eval_config2()
    print(f"eval config 2: {out['eval_config2']}", flush=True)
    out["eval_config3"] = eval_config3(seqs["seq3"])
    print(f"eval config 3: {out['eval_config3']}", flush=True)
    if args.config6:
        t0 = time.perf_counter()
        out["eval_config6"] = eval_config6()
        print(f"eval config 6: {out['eval_config6']} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

"""The port's EVAL harness: every row of EVAL.md (the pinned configs 1, 2,
2c, 3 (with 3b), 4, 5 and 6 of `scripts/eval_configs.py`) through
`vislam_tpu_torch` on the card, each row printed beside the reference's and
held to the reference's distribution over RANSAC seeds.

    python3 scripts/torch_eval_configs.py [--configs 1,2,2c,3,4,5,6]
                                          [--seeds N] [--out FILE] [--cpu]
                                          [--max-frames N]

Mirrors the reference harness's `run_vio` with each of its options (config
1: GT scale; 2: IMU scale open loop, + the window VI-BA on keyframes, and
the unsupervised open loop, with scale ratios; 3: GT scale plain,
+photometric and + the vision-only online BA, 3b at IMU scale open loop
and the VI-BA under the `ends` and `marg` gauges; 4: GT scale with the
keyframe archive and loop correction), `run_cold` (2c: v0 = 0, GT-free
VI-BA, bootstrap smoothing), `run_long` (6: 500 frames GT-free VI-BA,
keyframe archive, a checkpoint round trip at frame 250, loop correction)
and the batch of its main() (5: `run_batch_scan` over 8 sequences from
their true initial states) with the port's engine (`eval/runner.py`),
window refine, batch, checkpoint and map backend. The sequences are the
pinned ones (`PINNED` there). Imports no JAX and nothing of the JAX
package: the reference rows are the table `REFERENCE` below.

The port draws its RANSAC hypotheses from the reference's stream (JAX's
threefry keys, `utils/prng.py`; on the card one kernel a frame): its run at
seed d draws the reference's hypotheses at seed d, on the card and on the
CPU alike. So each metric gets a paired line: at each seed d, |port_d -
reference_d| against the reference's TPU-branch row at seed d, the largest
and its seed (printed, not held). The reference's own rows move by up to
0.01 m (config 1), 0.30-0.41 m (2c) and 0.10-0.29 m (6) from one RANSAC
seed to another. Each config runs at seeds 0 to n - 1 (`SEEDS`, or
--seeds; config 3, six runs a seed, at 6 to keep the whole harness near 25
minutes on the card) and each metric's values are held against the
reference's over its seeds 0-7: the two
medians within the reference's interquartile range, and the port's
smallest and largest value within the reference's range widened by that
range on each side; a count (`DISCRETE`: the loops closed) within the
reference's range; config 3's online BA at GT scale, neutral by design,
equal to the plain run at each seed within the reference's own largest
distance between the two (`NEUTRAL`). The reference is its TPU branch's
arithmetic (each detector response in float32 from the bfloat16 pyramid,
emulated on the CPU by `scripts/eval_reference_spread.py --branch tpu
--vary seed`), which the port implements; its CPU branch, which made
EVAL.md's rows, computes the response in bfloat16 and is printed beside
(EVAL.md r05, and at HEAD). A config run at one seed (config 6 by default:
~230 s a run on the card) is printed beside the reference's median and
range, not held; its checkpoint round trip is held (bitwise). Prints each
config's seconds and the card's name and power limit. Writes neither
EVAL.md nor EVAL_HISTORY.json; exits 1 if a held check fails. --cpu and
--max-frames are for a quick check off the card (rows then are not held).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The pinned sequences (scripts/eval_configs.py PINNED and main()); config
# 5 steps one sequence per seed in BATCH_SEEDS.
SEQUENCES = {
    "1": dict(n_frames=80, n_landmarks=300, seed=0),
    "2": dict(n_frames=80, n_landmarks=300, seed=0),
    "2c": dict(n_frames=60, n_landmarks=300, seed=0),
    "3": dict(n_frames=60, n_landmarks=350, seed=1, trans_amp=(2.0, 1.4, 0.7),
              rot_amp=(0.12, 0.15, 0.3)),
    "4": dict(n_frames=86, n_landmarks=300, seed=21),
    "5": dict(n_frames=24, n_landmarks=250),
    "6": dict(n_frames=500, n_landmarks=400, seed=42),
}
BATCH_SEEDS = range(8)

# The port's runs per config (RANSAC seeds 0 to n - 1). Config 3 runs six
# sequences a seed (~107 s on an H100): at 8 seeds the harness took ~30
# minutes, at 6 ~26. Seed 5 stays in: under the port's earlier stream (a
# torch generator on the card) its online BA parted from its plain run by
# 5.85e-4 m (ATE), a near-tied inlier count at frame 31 flipped by the
# refine's 2.4e-7 m move of the live anchor (scripts/torch_eval_divergence.py).
SEEDS = {"1": 8, "2": 8, "2c": 8, "3": 6, "4": 8, "5": 8, "6": 1}

# The reference's rows, from scripts/eval_reference_spread.py on the CPU
# (configs 1, 2c and 6 at c0cd5dc, 2, 3, 4 and 5 at f1a1e33; the JAX package
# is the same at both): "tpu" its TPU branch's rows at RANSAC seeds 0-7
# (--branch tpu --vary seed --draws 8), "cpu" its CPU branch's row at seed 0
# (EVAL.md r05's row is "r05", the regeneration at 6eb020b "head_pr10").
REFERENCE = {
    "1": {
        "ate": dict(r05=0.200, cpu=0.200192,
                    tpu=(0.188346, 0.180522, 0.186334, 0.186069, 0.177398, 0.189083,
                         0.178135, 0.175414)),
    },
    "2c": {
        "ate_live": dict(r05=0.737, cpu=0.736654,
                         tpu=(0.431682, 0.728766, 0.399298, 0.431284, 0.613906, 0.452997,
                              0.390267, 0.423598)),
        "ate_smoothed": dict(r05=0.686, cpu=0.686494,
                             tpu=(0.329134, 0.743517, 0.293060, 0.334682, 0.728374, 0.358110,
                                  0.288385, 0.324015)),
    },
    "2": {
        "ate": dict(r05=0.382, cpu=0.382330,
                    tpu=(0.397028, 0.379395, 0.394973, 0.357146, 0.370410, 0.369162, 0.383955,
                         0.405717)),
        "scale_ratio": dict(r05=1.017, cpu=1.017082,
                    tpu=(1.024169, 1.022322, 1.023137, 0.989828, 1.022664, 1.023862, 1.018702,
                         1.015679)),
        "ate_vi_ba": dict(r05=0.418, cpu=0.355411,
                    tpu=(0.377461, 0.360474, 0.392729, 0.365951, 0.355009, 0.353233, 0.364051,
                         0.378575)),
        "scale_ratio_vi_ba": dict(r05=0.894, cpu=0.902769,
                    tpu=(0.891454, 0.896730, 0.879752, 0.897059, 0.897538, 0.898142, 0.898708,
                         0.889116)),
        "ate_open_unsupervised": dict(r05=0.791, cpu=0.790904,
                    tpu=(0.779062, 0.780810, 0.773526, 0.777752, 0.779491, 0.780371, 0.784450,
                         0.780590)),
    },
    "3": {
        "ate_plain": dict(r05=0.108, cpu=0.107582,
                    tpu=(0.108058170, 0.108014925, 0.108176729, 0.110626344, 0.109110548,
                         0.107667679, 0.108022217, 0.107005606)),
        "ate_photometric": dict(r05=0.104, cpu=0.104036,
                    tpu=(0.101317, 0.103508, 0.104930, 0.103702, 0.101878, 0.105871, 0.111691,
                         0.109498)),
        "ate_online_ba": dict(r05=0.108, cpu=0.107583,
                    tpu=(0.108059369, 0.108015621, 0.108177845, 0.110626792, 0.109111007,
                         0.107667283, 0.108023445, 0.107006365)),
        "ate_vi_open_loop": dict(r05=0.351, cpu=0.350952,
                    tpu=(0.349031, 0.347262, 0.347614, 0.349123, 0.348942, 0.347496, 0.345928,
                         0.347264)),
        "ate_vi_online_ba_ends": dict(r05=0.257, cpu=0.269493,
                    tpu=(0.277292, 0.278642, 0.277958, 0.277679, 0.277586, 0.277284, 0.277710,
                         0.275559)),
        "ate_vi_online_ba_marg": dict(r05=0.553, cpu=0.151465,
                    tpu=(0.168529, 0.170519, 0.165744, 0.170501, 0.167805, 0.167508, 0.159625,
                         0.166443)),
    },
    "4": {
        "ate_open_loop": dict(r05=0.177, cpu=0.176682,
                    tpu=(0.176490, 0.175810, 0.181239, 0.169559, 0.182256, 0.175756, 0.173299,
                         0.171827)),
        "n_loops": dict(r05=4, cpu=4,
                    tpu=(5, 6, 6, 5, 5, 6, 7, 5)),
        "kf_maxerr_before": dict(r05=0.267, cpu=0.266856,
                    tpu=(0.261246, 0.257787, 0.269249, 0.249335, 0.271671, 0.256890, 0.249500,
                         0.247523)),
        "kf_maxerr_after": dict(r05=0.146, cpu=0.146025,
                    tpu=(0.121259, 0.130588, 0.125958, 0.129742, 0.124610, 0.127868, 0.130339,
                         0.120635)),
    },
    "5": {
        "ate_mean": dict(r05=0.098, cpu=0.097730,
                    tpu=(0.096733, 0.096066, 0.097200, 0.097652, 0.096300, 0.096698, 0.095712,
                         0.097409)),
        "ate_max": dict(r05=0.105, cpu=0.105328,
                    tpu=(0.111553, 0.107697, 0.108764, 0.104736, 0.105587, 0.110213, 0.105147,
                         0.108346)),
    },
    "6": {
        "ate_full": dict(r05=0.981, head_pr10=0.8036, cpu=0.803273,
                         tpu=(0.815856, 0.786736, 0.779927, 1.068147, 0.829018, 0.795419,
                              0.782069, 0.976065)),
        "ate_f1_100": dict(r05=0.597, head_pr10=0.5326, cpu=0.532389,
                           tpu=(0.500333, 0.500284, 0.489204, 0.735522, 0.512709, 0.493132,
                                0.523208, 0.664692)),
        "ate_f100_300": dict(r05=0.984, head_pr10=0.8155, cpu=0.815331,
                             tpu=(0.861839, 0.844683, 0.832514, 1.117662, 0.871032, 0.845360,
                                  0.850527, 1.019193)),
        "ate_f300_500": dict(r05=1.123, head_pr10=0.8990, cpu=0.898580,
                             tpu=(0.892624, 0.842141, 0.841712, 1.154835, 0.910358, 0.863754,
                                  0.817984, 1.059691)),
        "kf_maxerr_before": dict(r05=1.616, head_pr10=1.4077, cpu=1.407679,
                                 tpu=(1.414552, 1.419193, 1.362035, 1.703743, 1.428348,
                                      1.389567, 1.412506, 1.593286)),
        "kf_maxerr_after": dict(r05=1.299, head_pr10=1.4777, cpu=1.477850,
                                tpu=(0.767415, 0.769157, 0.760164, 0.863896, 0.762425,
                                     0.777383, 0.746701, 0.794466)),
    },
}


# What a runner returns for the tests, not printed in a row.
DETAIL = ("poses", "loops")
# Counts, held within the reference's range (not widened).
DISCRETE = {"n_loops"}
# GT-scale online BA (the vision-only window, `ends` gauge) is neutral by
# design in the reference: the gauge pins the live anchor. Per seed, the
# port's first row equals its second within the reference's own largest
# distance between them.
NEUTRAL = {"3": ("ate_online_ba", "ate_plain")}


def _imu(seq, j):
    lo, hi = (j - 1) * 10, j * 10
    imu = np.zeros((16, 6), np.float32)
    if len(seq["imu_gyro"]) >= hi:
        imu[:10] = np.concatenate([seq["imu_gyro"][lo:hi], seq["imu_accel"][lo:hi]], -1)
    dt = np.zeros(16, np.float32)
    dt[:10] = 1 / 200.0
    return imu, dt


def _with(**sections):
    """SystemConfig() with the given sections' fields replaced."""
    from vislam_tpu_torch.utils.config import SystemConfig

    c = SystemConfig()
    return dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), **v)
                                     for k, v in sections.items()})


def _vio(seq, device, seed, cfg=None, gt_scale=True, ba=False, vi_ba=False,
         photometric=False) -> dict:
    """The reference harness's `run_vio` without loop correction, through
    `eval/runner.py`: ba refines the window (vision only) on keyframes,
    vi_ba adds the IMU factors, photometric the photometric refine."""
    from vislam_tpu_torch.eval import run_vio_sequence

    cfg = cfg or _with()
    if photometric:
        cfg = dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, photometric_refine=True))
    return run_vio_sequence(seq, cfg, gt_scale=gt_scale, online_ba=ba or vi_ba,
                            vi_factors=True if vi_ba else None, device=device, seed=seed)


def _path_length(p) -> float:
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def run_vio(seq, device, seed) -> dict:
    """Config 1: the default step at GT scale (`eval/runner.py`)."""
    t0 = time.perf_counter()
    r = _vio(seq, device, seed)
    return {"ate": r["ate"], "fps": (len(seq["images"]) - 1) / (time.perf_counter() - t0)}


def run_imu_scale(seq, device, seed) -> dict:
    """Config 2: IMU scale, open loop and with the window VI-BA on
    keyframes (scale ratio: estimated over true path length), and the
    unsupervised open loop (vi_align_bootstrap off)."""
    r = _vio(seq, device, seed, gt_scale=False)
    r_vb = _vio(seq, device, seed, gt_scale=False, vi_ba=True)
    r_un = _vio(seq, device, seed, _with(engine=dict(vi_align_bootstrap=False)),
                gt_scale=False)
    gl = _path_length(r["gt"])
    return {"ate": r["ate"], "scale_ratio": _path_length(r["poses"]) / gl,
            "ate_vi_ba": r_vb["ate"], "scale_ratio_vi_ba": _path_length(r_vb["poses"]) / gl,
            "ate_open_unsupervised": r_un["ate"]}


def run_aggressive(seq, device, seed) -> dict:
    """Configs 3 and 3b: at GT scale plain, +photometric and +online BA
    (vision only, the `ends` gauge); at IMU scale open loop and the window
    VI-BA under the `ends` and the `marg` gauge."""
    return {
        "ate_plain": _vio(seq, device, seed)["ate"],
        "ate_photometric": _vio(seq, device, seed, photometric=True)["ate"],
        "ate_online_ba": _vio(seq, device, seed, ba=True)["ate"],
        "ate_vi_open_loop": _vio(seq, device, seed, gt_scale=False)["ate"],
        "ate_vi_online_ba_ends": _vio(seq, device, seed, gt_scale=False, vi_ba=True)["ate"],
        "ate_vi_online_ba_marg": _vio(seq, device, seed,
                                      _with(backend=dict(online_gauge="marg")),
                                      gt_scale=False, vi_ba=True)["ate"],
    }


def run_loop(seq, device, seed, cfg=None) -> dict:
    """Config 4: the step (cfg, default SystemConfig()) at GT scale, each
    keyframe archived (`record_from_feat`), then `correct_trajectory` of the
    archive (the reference harness's settings)."""
    from vislam_tpu_torch.backend.trajectory_opt import record_from_feat
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.eval import ate_rmse

    calib = seq["calib"]
    eng = VIOEngine(calib, cfg or _with(), seed, device=device)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=seq["gt_vel"][0],
                           p_w0=seq["gt_pos"][0])
    n = len(seq["images"])
    poses, archive, last_kf = [], [], 0
    for j in range(1, n):
        imu, dt = _imu(seq, j)
        gt_norm = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        state, res = eng.step(state, seq["images"][j], imu, dt, gt_norm)
        if bool(res.is_keyframe):
            last_kf = j
            archive.append(record_from_feat(j, state.kf_R_wc, state.kf_p_wc, state.kf_feat))
        poses.append(state.p_wc.cpu().numpy())
    poses = np.array(poses)
    return {"ate_open_loop": ate_rmse(poses, seq["gt_pos"][1:n], align=False), "n_loops": 0,
            "n_keyframes": len(archive), "poses": poses, "loops": [],
            **_correct(seq, archive, device)}


def _correct(seq, archive, device) -> dict:
    """Loop correction of a keyframe archive with the reference harness's
    settings (none with 10 keyframes or fewer): the loops and the
    keyframes' largest error before and after."""
    from vislam_tpu_torch.backend.trajectory_opt import correct_trajectory

    if len(archive) <= 10:
        return {}
    calib = seq["calib"]
    t0 = time.perf_counter()
    p_corr, _, info = correct_trajectory(archive, calib.fx, calib.fy, calib.cx, calib.cy,
                                         min_separation=10, sim_thresh=0.80, min_inliers=25,
                                         device=device)
    kf_gt = np.array([seq["gt_pos"][k.frame_index] for k in archive])
    return {"n_loops": len(info["loops"]), "loops": info["loops"],
            "kf_maxerr_before": float(np.linalg.norm(
                np.stack([k.p_wc for k in archive]) - kf_gt, axis=-1).max()),
            "kf_maxerr_after": float(np.linalg.norm(p_corr - kf_gt, axis=-1).max()),
            "correct_s": time.perf_counter() - t0}


def run_batch(seqs, device, seed, cfg=None, noises=None) -> dict:
    """Config 5: `run_batch_scan` over the sequences from their true initial
    states at GT scale (the reference's main(): RANSAC stream `seed`, or
    the draws `noises` as run_batch_scan takes them; cfg default
    SystemConfig()), the mean and largest ATE over the entries."""
    from vislam_tpu_torch.engine import (
        VIOEngine,
        make_batch_inputs,
        make_sequence_inputs,
        run_batch_scan,
        stack_states,
    )
    from vislam_tpu_torch.eval import ate_rmse

    n = len(seqs[0]["images"])
    eng = VIOEngine(seqs[0]["calib"], cfg or _with(), device=device)
    states = stack_states([eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0],
                                          v_w0=s["gt_vel"][0], p_w0=s["gt_pos"][0])
                           for s in seqs])
    inputs = make_batch_inputs([make_sequence_inputs(s, device=device) for s in seqs])
    kf0 = np.stack([s["gt_pos"][0] for s in seqs]).astype(np.float32)
    t0 = time.perf_counter()
    _, res = run_batch_scan(eng, states, inputs, kf0, seed=seed, noises=noises)
    p = res.p_wc.cpu().numpy()
    wall = time.perf_counter() - t0
    ates = [float(ate_rmse(p[b], s["gt_pos"][1:n], align=False)) for b, s in enumerate(seqs)]
    return {"ate_mean": float(np.mean(ates)), "ate_max": float(np.max(ates)),
            "fps": len(seqs) * (n - 1) / wall, "poses": p}


def run_cold(seq, device, seed) -> dict:
    """Config 2c: cold start (v0 = 0) under the default GT-free mode, the
    window refined on keyframes, the live and bootstrap-smoothed ATE."""
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.engine.refine import refine_window
    from vislam_tpu_torch.eval import ate_rmse, smooth_bootstrap_prefix

    calib = seq["calib"]
    eng = VIOEngine(calib, _with(backend=dict(vi_factors=True)), seed, device=device)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=np.zeros(3),
                           p_w0=seq["gt_pos"][0])
    n = len(seq["images"])
    poses, shadows, applies = [], [], []
    t0 = time.perf_counter()
    for j in range(1, n):
        imu, dt = _imu(seq, j)
        state, res = eng.step(state, seq["images"][j], imu, dt, -1.0)
        if bool(res.is_keyframe):
            state = refine_window(state, eng.cfg, calib.fx, calib.fy, calib.cx, calib.cy)
        poses.append(state.p_wc.cpu().numpy())
        shadows.append(state.shadow_p_wc.cpu().numpy())
        applies.append(int(state.bootstrap_applies))
    wall = time.perf_counter() - t0
    poses = np.array(poses)
    gt = seq["gt_pos"][1:n]
    sm = smooth_bootstrap_prefix(poses, np.array(shadows), np.array(applies),
                                 state.origin_p_wc.cpu().numpy(),
                                 state.shadow_origin_p.cpu().numpy())
    return {"ate_live": ate_rmse(poses, gt, align=False),
            "ate_smoothed": ate_rmse(sm, gt, align=False),
            "n_applies": int(applies[-1]) if applies else 0,
            "aligned": bool(state.vi_aligned), "fps": (n - 1) / wall}


def _leaves(tree):
    for v in tree:
        if isinstance(v, tuple):
            yield from _leaves(v)
        else:
            yield v


def run_long(seq, device, seed) -> dict:
    """Config 6: 500 frames GT-free VI-BA, each keyframe refined and
    archived, a checkpoint round trip at frame 250 (the resumed state must
    equal the saved one bitwise), the rotation's orthogonality error, and
    loop correction of the archive after the run."""
    from vislam_tpu_torch.backend.trajectory_opt import record_from_feat
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.engine.refine import refine_window
    from vislam_tpu_torch.eval import ate_rmse
    from vislam_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    import torch

    calib = seq["calib"]
    eng = VIOEngine(calib, _with(backend=dict(vi_factors=True)), seed, device=device)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=seq["gt_vel"][0],
                           p_w0=seq["gt_pos"][0])
    n = len(seq["images"])
    poses, archive = [], []
    ortho_err_max, ckpt_resumed = 0.0, None
    t0 = time.perf_counter()
    for j in range(1, n):
        imu, dt = _imu(seq, j)
        state, res = eng.step(state, seq["images"][j], imu, dt, -1.0)
        if bool(res.is_keyframe):
            state = refine_window(state, eng.cfg, calib.fx, calib.fy, calib.cx, calib.cy)
            archive.append(record_from_feat(j, state.kf_R_wc, state.kf_p_wc, state.kf_feat))
            R = archive[-1].R_wc.astype(np.float64)
            ortho_err_max = max(ortho_err_max, float(np.abs(R @ R.T - np.eye(3)).max()))
        if j == 250:
            with tempfile.TemporaryDirectory() as td:
                p = os.path.join(td, "ck.npz")
                save_checkpoint(p, state, j, {"last_kf": j})
                state2, fidx = load_checkpoint(p, device=device)
            ckpt_resumed = bool(fidx == j and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(_leaves(state), _leaves(state2))))
            state = state2
        poses.append(state.p_wc.cpu().numpy())
    wall = time.perf_counter() - t0
    poses = np.array(poses)
    gt = seq["gt_pos"][1:n]
    return {
        "ate_full": ate_rmse(poses, gt, align=False),
        "ate_f1_100": ate_rmse(poses[:100], gt[:100], align=False),
        "ate_f100_300": ate_rmse(poses[100:300], gt[100:300], align=False),
        "ate_f300_500": ate_rmse(poses[300:], gt[300:], align=False),
        "n_keyframes": len(archive),
        "ortho_err_max": ortho_err_max,
        "ckpt_resume_bitwise": ckpt_resumed,
        "fps": (n - 1) / wall,
        **_correct(seq, archive, device),
    }


RUNNERS = {"1": run_vio, "2": run_imu_scale, "2c": run_cold, "3": run_aggressive,
           "4": run_loop, "5": run_batch, "6": run_long}


def _quartiles(x):
    lo, med, hi = np.percentile(np.asarray(x, np.float64), [25, 50, 75])
    return float(med), float(hi - lo)


def hold(name: str, runs: list) -> list:
    """(metric, line, ok) for each metric of the reference table: the port's
    runs against the reference's seeds; ok is None where not held (one
    run). A count (DISCRETE) is held within the reference's range; config
    3's online BA at GT scale to its plain run (`hold_neutral`)."""
    out = []
    for metric, ref in REFERENCE.get(name, {}).items():
        got = [r[metric] for r in runs if metric in r]
        if not got:
            continue
        r_med, r_iqr = _quartiles(ref["tpu"])
        r_lo, r_hi = min(ref["tpu"]), max(ref["tpu"])
        p_med, _ = _quartiles(got)
        cpu = ", ".join(f"{k} {ref[k]}" for k in ("cpu", "r05", "head_pr10") if k in ref)
        line = (f"  {metric}: port median {p_med:.4f} [{min(got):.4f}, {max(got):.4f}] over "
                f"{len(got)} seed{'s' if len(got) > 1 else ''} | reference, TPU branch, "
                f"median {r_med:.4f} [{r_lo:.4f}, {r_hi:.4f}] over {len(ref['tpu'])} seeds, "
                f"IQR {r_iqr:.4f}")
        if metric in DISCRETE:
            ok = bool(min(got) >= r_lo and max(got) <= r_hi)
            line += (f" | each run held within the reference's range: "
                     f"{'within' if ok else 'OUTSIDE'}")
        elif len(got) > 1:
            ok = bool(abs(p_med - r_med) <= r_iqr and min(got) >= r_lo - r_iqr
                      and max(got) <= r_hi + r_iqr)
            line += (f" | medians {abs(p_med - r_med):.4f} apart (held <= the IQR), the "
                     f"port's range held within [{r_lo - r_iqr:.4f}, {r_hi + r_iqr:.4f}]: "
                     f"{'within' if ok else 'OUTSIDE'}")
        else:
            ok = None
            line += (f" | printed, not held (one run; "
                     f"{'inside' if r_lo <= got[0] <= r_hi else 'outside'} the reference's "
                     f"range)")
        out.append((metric, line + f" | reference, CPU branch: {cpu}", ok))
        out.append(paired(metric, got, ref["tpu"]))
    if name in NEUTRAL:
        out.append(hold_neutral(name, runs))
    return out


def paired(metric: str, got: list, ref: tuple) -> tuple:
    """(metric, line, None): the port's run at seed d against the
    reference's at seed d (the same RANSAC draws), at each seed both runs
    have; printed, not held."""
    d = [abs(g - r) for g, r in zip(got, ref)]
    worst = int(np.argmax(d))
    return (f"{metric}/paired",
            f"  {metric} paired by seed: |port_d - reference_d| "
            f"{', '.join(f'{x:.2e}' for x in d)} over seeds 0-{len(d) - 1}; largest "
            f"{d[worst]:.3e} at seed {worst} (port {got[worst]:.6f}, reference "
            f"{ref[worst]:.6f}); printed, not held", None)


def hold_neutral(name: str, runs: list) -> tuple:
    """(metric, line, ok): at each seed the port's row NEUTRAL[name][0]
    equals its row NEUTRAL[name][1] within the largest distance between the
    two rows over the reference's seeds."""
    a, b = NEUTRAL[name]
    tol = max(abs(x - y) for x, y in zip(REFERENCE[name][a]["tpu"], REFERENCE[name][b]["tpu"]))
    d = max(abs(r[a] - r[b]) for r in runs)
    ok = bool(d <= tol)
    return (f"{a}-{b}", f"  {a} - {b}: at most {d:.3e} m apart over {len(runs)} seeds "
                        f"(neutral by design: the ends gauge pins the live anchor), held <= "
                        f"{tol:.3e} m, the reference's largest over its seeds: "
                        f"{'within' if ok else 'OUTSIDE'}", ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,2c,3,4,5,6")
    ap.add_argument("--seeds", type=int, default=0,
                    help="the port's runs per config (default: SEEDS)")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a quick check)")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="cut each sequence (a quick check; rows are then not held)")
    args = ap.parse_args(argv)
    import torch

    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine.engine import require_device

    device = require_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}",
              flush=True)
    held = not args.cpu and not args.max_frames
    rows, failed = {}, []
    for name in args.configs.split(","):
        kw = dict(SEQUENCES[name])
        if args.max_frames:
            kw["n_frames"] = min(kw["n_frames"], args.max_frames)
        if name == "5":
            seq = [make_synthetic_sequence(SyntheticConfig(**kw, seed=b)) for b in BATCH_SEEDS]
        else:
            seq = make_synthetic_sequence(SyntheticConfig(**kw))
        rows[name] = []
        t_config = time.perf_counter()
        for seed in range(args.seeds or SEEDS[name]):
            t0 = time.perf_counter()
            row = {k: v for k, v in RUNNERS[name](seq, device, seed).items()
                   if k not in DETAIL}
            row["seconds"] = time.perf_counter() - t0
            rows[name].append(row)
            print(f"config {name} seed {seed} ({row['seconds']:.1f} s): "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in row.items() if k != "seconds"), flush=True)
            if held and row.get("ckpt_resume_bitwise") is False:
                failed.append(f"{name}/seed {seed}/ckpt_resume_bitwise")
        print(f"config {name}: {len(rows[name])} runs in {time.perf_counter() - t_config:.1f} s",
              flush=True)
        for metric, line, ok in hold(name, rows[name]):
            print(line, flush=True)
            if held and ok is False:
                failed.append(f"{name}/{metric}")
    for r in rows.get("6", []):
        print(f"config 6 loop correction: keyframe max error {r.get('kf_maxerr_before', 0):.4f}"
              f" -> {r.get('kf_maxerr_after', 0):.4f} m with {r.get('n_loops', 0)} loops "
              f"(the reference's CPU branch: 1.4077 -> 1.4779 m with 6 loops, worse; its "
              f"TPU branch at seed 0: 1.4146 -> 0.7674 m with 6 loops, better)",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1, default=float)
    print(json.dumps({"rows": rows, "failed": failed}, default=float))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

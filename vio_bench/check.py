"""The comparison that decides `correct`: the program's per-frame outputs
from the timed window against the plain reference (`reference.py`).

The inertial chain of every sequence is recomputed from the IMU alone, and
the IMU prediction of every frame of every pass from it and the program's
velocity of the frame before. A sample of the window's sequence-frames,
drawn from the seed, is recomputed by the reference from the frames and
the program's own state at that frame (which image is the keyframe, the
keyframe pose, the velocity of the frame before: each read off the
window's outputs); the frames where the program took the guided rescue,
which is rare, join the sample. Ten numbers, each held to the cell's
limit:

  frames_apart_pct      the share of sampled frames whose match count,
                        inlier count, rescue flag or keyframe flag differs
  flags_apart_pct       the share of sampled frames whose keyframe flag or
                        rescue flag differs
  t_dir_gap_p90_deg     the 90th percentile over the sampled frames of the
                        angle between the two translation directions
  t_dir_gap_max_deg     the widest of those angles
  pose_gap_p90_m        the 90th percentile over the sampled frames of the
                        distance between the two positions (the GT-scaled
                        composition, or the IMU pose where the frame is not
                        solved)
  pose_gap_max_m        the widest of those distances
  velocity_gap_p90_mps  the 90th percentile of the two velocities' distance
  velocity_gap_max_mps  the widest of those distances
  pred_gap_m            the widest distance between the two IMU-predicted
                        translations, every frame of every pass
  attitude_gap_deg      the widest angle between the two attitudes, every
                        frame of every pass

Each sampled gap is held twice. Where round-off moves one keypoint across
a top-k or ratio threshold (a few frames in a hundred on the card, more
with the FED kernel) the frame's match set changes and its direction moves
by up to about a degree with its counts unchanged: the percentile, held
tight, sees the round-off of the frames that agree, and the widest gap,
held above what such a changed match set moves, sees a fault confined to
a few frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vio_bench import reference as R
from vio_bench.generator import CAM_RATE_HZ

RESCUED_MAX = 16

NUMBERS = ("frames_apart_pct", "flags_apart_pct", "t_dir_gap_p90_deg", "t_dir_gap_max_deg",
           "pose_gap_p90_m", "pose_gap_max_m", "velocity_gap_p90_mps", "velocity_gap_max_mps",
           "pred_gap_m", "attitude_gap_deg")


class Outputs(NamedTuple):
    """Per-frame outputs on the host, one record per sampled frame."""

    num_matches: np.ndarray
    num_inliers: np.ndarray
    used_fallback: np.ndarray
    is_keyframe: np.ndarray
    t_dir: np.ndarray
    p_wc: np.ndarray
    v_w: np.ndarray


def host_results(results) -> dict:
    """The window's FrameResults (one per pass, (B, N, ...) on the device)
    as numpy arrays (P, B, N, ...)."""
    fields = ("p_wc", "R_wc", "q_wb", "v_w", "is_keyframe", "num_matches", "num_inliers",
              "used_fallback", "t_dir_cam", "t_pred_cam")
    return {f: np.stack([getattr(r, f).cpu().numpy() for r in results]) for f in fields}


def draw_sample(seed: int, passes: int, B: int, N: int, size: int, rescued=()) -> list:
    """`size` distinct (pass, sequence, frame) triples drawn from the seed,
    the last frame of a sequence among them, and up to RESCUED_MAX of the
    `rescued` triples (the frames where the program took the rescue)
    besides."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 3])
    total = passes * B * N
    flat = rng.choice(total, size=min(size, total), replace=False)
    out = [(int(f // (B * N)), int(f // N % B), int(f % N)) for f in flat]
    if not any(n == N - 1 for _, _, n in out):
        out[-1] = (out[-1][0], out[-1][1], N - 1)
    drawn = set(out)
    rescued = [t for t in map(tuple, rescued) if t not in drawn]
    picked = rng.permutation(len(rescued))[:RESCUED_MAX]
    return out + [tuple(int(x) for x in rescued[i]) for i in sorted(picked)]


def quat_gap_deg(a, b):
    """Rotation angle between unit quaternions (..., 4), sign-blind."""
    s = np.sign(np.sum(a * b, -1, keepdims=True))
    s[s == 0] = 1.0
    d = np.linalg.norm(a - s * b, axis=-1)
    return np.degrees(4.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0)))


def dir_gap_deg(a, b):
    return np.degrees(2.0 * np.arcsin(np.clip(np.linalg.norm(a - b, axis=-1) / 2.0, 0.0, 1.0)))


def widest(gaps) -> float:
    """The largest gap, a NaN counting as infinitely wide."""
    return float(np.nan_to_num(gaps, nan=np.inf).max())


def p90(gaps) -> float:
    return float(np.quantile(np.nan_to_num(gaps, nan=np.inf), 0.9))


def readings(got: Outputs, ref: Outputs, pred_got, pred_ref, q_got, q_ref) -> dict:
    """The ten numbers of `got` against `ref`: sampled Outputs, the
    predictions (P, B, N, 3) and the attitudes (P or 1, B, N, 4)."""
    flags = (got.used_fallback == ref.used_fallback) & (got.is_keyframe == ref.is_keyframe)
    agree = flags & (got.num_matches == ref.num_matches) & (got.num_inliers == ref.num_inliers)
    t_dir = dir_gap_deg(got.t_dir, ref.t_dir)
    pose = np.linalg.norm(got.p_wc - ref.p_wc, axis=-1)
    velocity = np.linalg.norm(got.v_w - ref.v_w, axis=-1)
    return {
        "frames_apart_pct": 100.0 * float(np.mean(~agree)),
        "flags_apart_pct": 100.0 * float(np.mean(~flags)),
        "t_dir_gap_p90_deg": p90(t_dir),
        "t_dir_gap_max_deg": widest(t_dir),
        "pose_gap_p90_m": p90(pose),
        "pose_gap_max_m": widest(pose),
        "velocity_gap_p90_mps": p90(velocity),
        "velocity_gap_max_mps": widest(velocity),
        "pred_gap_m": widest(np.linalg.norm(pred_got - pred_ref, axis=-1)),
        "attitude_gap_deg": widest(quat_gap_deg(q_got, q_ref)),
    }


def program_sample(res: dict, sample) -> Outputs:
    idx = tuple(np.array(c) for c in zip(*sample))
    return Outputs(res["num_matches"][idx], res["num_inliers"][idx], res["used_fallback"][idx],
                   res["is_keyframe"][idx], res["t_dir_cam"][idx].astype(np.float64),
                   res["p_wc"][idx].astype(np.float64), res["v_w"][idx].astype(np.float64))


def frame_state(res: dict, batch, p: int, b: int, n: int):
    """The program's state at frame n of sequence b in pass p, read off its
    outputs: the keyframe's image index, rotation and position."""
    kfs = np.nonzero(res["is_keyframe"][p, b, :n])[0]
    if len(kfs) == 0:
        q0 = torch.as_tensor(batch.gt_quat[b, 0], dtype=torch.float32)
        return 0, R.quat_to_mat(q0), torch.as_tensor(batch.gt_pos[b, 0], dtype=torch.float32)
    k = int(kfs[-1])
    return (k + 1, torch.as_tensor(res["R_wc"][p, b, k]),
            torch.as_tensor(res["p_wc"][p, b, k]))


def inertial(res: dict, batch, system: dict, prec: R.Precision, device):
    """The reference's attitude of every frame and the IMU prediction of
    every frame of every pass (from the program's velocities and flags)."""
    en = system["engine"]
    q0 = torch.as_tensor(batch.gt_quat[:, 0], dtype=torch.float32, device=device)
    v0 = torch.as_tensor(batch.gt_vel[:, 0], dtype=torch.float32, device=device)
    imu, imu_dt = batch.imu.to(device), batch.imu_dt.to(device)
    att = R.attitude(q0, imu, imu_dt, en, prec)
    imu_pred = R.predict(att, q0, v0, imu, imu_dt, torch.as_tensor(res["v_w"], device=device),
                         torch.as_tensor(res["is_keyframe"], device=device), en, CAM_RATE_HZ,
                         prec)
    return att, imu_pred


def reference_sample(res: dict, batch, pass_seeds, sample, system: dict, cam, att, imu_pred,
                     prec: R.Precision, device, block: int = 16) -> Outputs:
    """The reference's outputs at each sampled frame."""
    fe = system["frontend"]
    states = [frame_state(res, batch, *s) for s in sample]
    need = sorted({(b, n + 1) for (_, b, n) in sample} | {(s[1], st[0]) for s, st in
                                                           zip(sample, states)})
    feats = {}
    for lo in range(0, len(need), block):
        part = need[lo:lo + block]
        imgs = torch.stack([batch.images[b, i] for b, i in part]).to(device)
        f = R.extract(imgs, fe, prec)
        for j, key in enumerate(part):
            feats[key] = R.Features(*[x[j:j + 1] for x in f])
    outs = []
    for (p, b, n), (kf_img, kf_R, kf_p) in zip(sample, states):
        R_wc_j = R.quat_to_mat(att.q[b, n].float())
        R_ji = R_wc_j.T @ kf_R.to(device)
        key = R.fold_in(R.fold_in(R.prng_key(pass_seeds[p], device), b), n)
        gt_norm = float(np.linalg.norm(batch.gt_pos[b, n + 1].astype(np.float32)
                                       - batch.gt_pos[b, kf_img].astype(np.float32)))
        outs.append(R.frame(feats[(b, n + 1)], feats[(b, kf_img)], R_ji, key,
                            imu_pred.at(p, b, n), gt_norm, kf_R.to(device), kf_p.to(device),
                            cam, system, prec))
    return Outputs(*[np.array([getattr(o, f) for o in outs]) for f in
                     ("num_matches", "num_inliers", "used_fallback", "is_keyframe")],
                   *[np.stack([getattr(o, f).cpu().numpy() for o in outs])
                     for f in ("t_dir", "p_wc", "v_w")])


def compare(res: dict, batch, pass_seeds, seed: int, system: dict, cam, sample_size: int,
            device, control: bool = False) -> dict:
    """The ten numbers of the window's outputs against the reference (and,
    with control, of the reference computed one precision lower)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P, B, N = res["num_matches"].shape
    sample = draw_sample(seed, P, B, N, sample_size, np.argwhere(res["used_fallback"]))

    def side(prec):
        att, imu_pred = inertial(res, batch, system, prec, device)
        out = reference_sample(res, batch, pass_seeds, sample, system, cam, att, imu_pred, prec,
                               device)
        return (out, imu_pred.t_pred.double().cpu().numpy(),
                att.q.double().cpu().numpy()[None])

    ref = side(R.STATED)
    out = {"program": readings(program_sample(res, sample), ref[0],
                               res["t_pred_cam"].astype(np.float64), ref[1],
                               res["q_wb"].astype(np.float64), ref[2])}
    if control:
        low = side(R.CONTROL)
        out["control"] = readings(low[0], ref[0], low[1], ref[1], low[2], ref[2])
    return out

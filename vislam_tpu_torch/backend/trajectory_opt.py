"""Offline trajectory correction: loop detection and pose-graph correction
over the keyframe archive (port of `vislam_tpu/backend/trajectory_opt.py`).

The archive (`KeyframeRecord`s: pose and fine-level features in host
memory) comes from the host loop (`record_from_feat` on each keyframe) or
from a scan's results (`keyframes_from_scan`). `correct_trajectory` finds
candidate pairs by global descriptors, measures each metrically
(`measure_relative_pose`: local triangulation and PnP, two calls of the
match kernel) and optimizes an SE(3) or Sim(3) pose graph of odometry and
loop edges. The device work runs on `device` (the card unless the caller
asks for the CPU); the archive crosses to it in one copy per call and the
host reads each decision in one copy.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from vislam_tpu_torch.backend.loop import (
    detect_loop_candidates,
    global_descriptors,
    rays,
    take_rows,
)
from vislam_tpu_torch.backend.pnp import pnp_gn
from vislam_tpu_torch.backend.pose_graph import PoseGraph, odometry_edges, optimize_pose_graph
from vislam_tpu_torch.backend.sim3_graph import Sim3Graph, optimize_sim3_graph
from vislam_tpu_torch.backend.triangulate import triangulate_midpoint
from vislam_tpu_torch.frontend.match import match_descriptors


class KeyframeRecord(NamedTuple):
    """Host-side keyframe archive entry (numpy arrays)."""

    frame_index: int
    R_wc: np.ndarray     # (3, 3)
    p_wc: np.ndarray     # (3,)
    uv: np.ndarray       # (K, 2)
    desc: np.ndarray     # (K, D)
    kp_mask: np.ndarray  # (K,)


def to_host(*xs) -> list:
    """float32 numpy copies of tensors, all fetched in one device-to-host
    copy (one wait for the device), and of arrays."""
    ts = [x for x in xs if torch.is_tensor(x)]
    flat = torch.cat([t.detach().reshape(-1).to(ts[0].device, torch.float32)
                      for t in ts]).cpu().numpy() if ts else None
    out, k = [], 0
    for x in xs:
        if torch.is_tensor(x):
            out.append(flat[k:k + x.numel()].reshape(tuple(x.shape)))
            k += x.numel()
        else:
            out.append(np.asarray(x, np.float32))
    return out


def to_device(device, *xs) -> list:
    """Tensors on `device` of numpy arrays (bool stays bool, integers become
    int32, floats float32), all in one host-to-device copy that does not
    wait for the device (from pinned memory on CUDA); tensors are moved as
    they are."""
    device = torch.device(device)
    arrays = [np.asarray(x) for x in xs if not torch.is_tensor(x)]
    dev = None
    if arrays:
        flat = torch.from_numpy(np.concatenate([a.astype(np.float32).reshape(-1)
                                                for a in arrays]))
        if device.type == "cuda":
            flat = flat.pin_memory()
        dev = flat.to(device, non_blocking=True)
    out, k = [], 0
    for x in xs:
        if torch.is_tensor(x):
            out.append(x.to(device, non_blocking=True))
            continue
        a = np.asarray(x)
        t = dev[k:k + a.size].reshape(a.shape)
        out.append(t > 0.5 if a.dtype == bool else
                   t.to(torch.int32) if np.issubdtype(a.dtype, np.integer) else t)
        k += a.size
    return out


def record_from_feat(frame_index: int, R_wc, p_wc, feat) -> KeyframeRecord:
    """Archive entry of a keyframe's pose and features (the engine's
    Features), fetched in one copy.

    Only fine-level (level-0) keypoints stay valid: the archive feeds metric
    PnP (loop edges, relocalization), where coarse keypoints' 2-4 px level-0
    localization degrades the solves.
    """
    R, p, uv, desc, mask, level = to_host(R_wc, p_wc, feat.uv, feat.desc, feat.mask, feat.level)
    return KeyframeRecord(frame_index=int(frame_index), R_wc=R, p_wc=p, uv=uv, desc=desc,
                          kp_mask=(mask > 0.5) & (level == 0))


def measure_relative_pose(ka: KeyframeRecord, kn: KeyframeRecord, desc_b, kp_mask_b, uv_b,
                          R0, t0, fx: float, fy: float, cx: float, cy: float,
                          min_inliers: int = 30, max_rmse: float = 3.0, device="cuda"):
    """Metric cam_b <- cam_a transform: triangulate landmarks in keyframe
    a's local neighbourhood (a with kn; odometry is metric over one step)
    and PnP-align them to their observations in view b, from (R0, t0).
    View b (desc_b, kp_mask_b, uv_b) is a record's arrays or live tensors.

    Returns (ok, R, t, n_inliers, rmse); R and t are None when not ok. The
    host waits twice: for the correspondence count, then for the solve.
    """
    R_an = (kn.R_wc.T @ ka.R_wc).astype(np.float32)     # a -> n
    t_an = (kn.R_wc.T @ (ka.p_wc - kn.p_wc)).astype(np.float32)
    (da, ma, uva, dn, mn, uvn, R_an, t_an, R0, t0, db, mb, uvb) = to_device(
        device, ka.desc, ka.kp_mask, ka.uv, kn.desc, kn.kp_mask, kn.uv, R_an, t_an,
        np.asarray(R0, np.float32), np.asarray(t0, np.float32), desc_b, kp_mask_b, uv_b)

    # 1. Local depths: a <-> n.
    m1 = match_descriptors(da, ma, dn, mn, ratio=0.8)
    X_a, d_i, d_j, gap = triangulate_midpoint(rays(uva, fx, fy, cx, cy),
                                              rays(take_rows(uvn, m1.idx_b), fx, fy, cx, cy),
                                              R_an, t_an)
    depth_ok = m1.mask & (d_i > 0.1) & (d_i < 100.0) & (d_j > 0.1) & (gap < 0.1 * d_i)

    # 2. Correspondences a <-> b.
    m2 = match_descriptors(da, ma, db, mb, ratio=0.8)
    corr = depth_ok & m2.mask
    if int(corr.sum()) < min_inliers:
        return False, None, None, 0, float("inf")

    # 3. PnP from the given start, then the gates.
    res = pnp_gn(X_a, take_rows(uvb, m2.idx_b), corr, R0, t0, fx, fy, cx, cy)
    R, t, n, rmse = to_host(res.R, res.t, res.num_inliers, res.rmse)
    n_inl, rmse = int(n), float(rmse)
    if n_inl < min_inliers or rmse > max_rmse:
        return False, None, None, n_inl, rmse
    return True, R, t, n_inl, rmse


def correct_trajectory(keyframes: List[KeyframeRecord], fx: float, fy: float, cx: float,
                       cy: float, min_separation: int = 8, sim_thresh: float = 0.85,
                       max_candidates: int = 8, min_inliers: int = 30, loop_weight: float = 5.0,
                       iters: int = 15, seed: int = 0, use_sim3: bool = False, device="cuda"):
    """Returns (corrected positions (N, 3), rotations (N, 3, 3), info) as
    numpy; info: loops [(a, b, inliers)], initial_cost, final_cost, scales.

    use_sim3 optimizes a 7-DoF similarity graph instead of SE(3), for
    odometry whose monocular scale drifts: a loop's scale error then spreads
    along the trajectory instead of being forced into pose error. A loop
    edge carries the measured cam_b <- cam_a transform (`seed` is unused,
    as in the reference: the measurement draws nothing).
    """
    N = len(keyframes)
    if N < min_separation + 2:
        return (np.stack([k.p_wc for k in keyframes]), np.stack([k.R_wc for k in keyframes]),
                {"loops": []})

    # Camera-to-world nodes: with T = [R_wc | p], T_i^-1 T_j is the cam_i <-
    # cam_j transform, so a measured loop transform is an edge as it is.
    R_n = np.stack([k.R_wc for k in keyframes]).astype(np.float32)
    t_n = np.stack([k.p_wc for k in keyframes]).astype(np.float32)
    desc, kp_mask, R_d, t_d = to_device(device, np.stack([k.desc for k in keyframes]),
                                        np.stack([k.kp_mask for k in keyframes]), R_n, t_n)

    # Loop candidates from global descriptors.
    cands = detect_loop_candidates(global_descriptors(desc, kp_mask),
                                   torch.ones(N, dtype=torch.bool, device=desc.device),
                                   min_separation=min_separation, sim_thresh=sim_thresh,
                                   max_candidates=max_candidates)
    idx_a, idx_b, cmask = to_host(cands.idx_a, cands.idx_b, cands.mask)

    # The metric measurement of each candidate: landmarks triangulated in
    # keyframe a's neighbourhood (a, a + 1), PnP-aligned to keyframe b, from
    # the current (drifted) estimate: a 6-DoF constraint free of the drift.
    loops = []
    for a, b, ok in zip(idx_a.astype(int), idx_b.astype(int), cmask > 0.5):
        a, b = int(a), int(b)
        if not ok or a + 1 >= N:
            continue
        ka, kn, kb = keyframes[a], keyframes[a + 1], keyframes[b]
        R0 = (kb.R_wc.T @ ka.R_wc).astype(np.float32)
        t0 = (kb.R_wc.T @ (ka.p_wc - kb.p_wc)).astype(np.float32)
        ok_m, R, t, n_inl, _ = measure_relative_pose(
            ka, kn, kb.desc, kb.kp_mask, kb.uv, R0, t0, fx, fy, cx, cy,
            min_inliers=min_inliers, device=device)
        if ok_m:
            loops.append((a, b, R, t, n_inl))

    # Pose graph: the odometry chain and the loop edges (i = b, j = a: the
    # measured cam_b <- cam_a transform).
    ei, ej, eR, et, w = odometry_edges(R_d, t_d)
    if loops:
        la, lb, lR, lt = to_device(device, np.asarray([b for _, b, *_ in loops], np.int32),
                                   np.asarray([a for a, *_ in loops], np.int32),
                                   np.stack([x[2] for x in loops]), np.stack([x[3] for x in loops]))
        ei, ej = torch.cat([ei, la]), torch.cat([ej, lb])
        eR, et = torch.cat([eR, lR]), torch.cat([et, lt])
        w = torch.cat([w, torch.full((len(loops),), loop_weight, dtype=w.dtype,
                                     device=w.device)])
    if use_sim3:
        ones = torch.ones(ei.shape[0], dtype=torch.float32, device=R_d.device)
        s0 = torch.ones(N, dtype=torch.float32, device=R_d.device)
        out, info = optimize_sim3_graph(Sim3Graph(R_d, t_d, s0, ei, ej, eR, et, ones, w),
                                        iters=iters)
        s = out.s
    else:
        out, info = optimize_pose_graph(PoseGraph(R_d, t_d, ei, ej, eR, et, w), iters=iters)
        s = torch.ones(N, dtype=torch.float32, device=R_d.device)
    R_o, p_o, scales, c0, c1 = to_host(out.R, out.t, s, info["initial_cost"],
                                       info["final_cost"])
    return p_o, R_o, {"loops": [(a, b, n) for a, b, _, _, n in loops],
                      "initial_cost": float(c0), "final_cost": float(c1), "scales": scales}


def keyframes_from_scan(images, results, fcfg, frame_offset: int = 1,
                        geom=None) -> List[KeyframeRecord]:
    """The keyframe archive of a scan's outputs: the scan carries no
    features, so each keyframe's are extracted again from its staged image
    (one `extract_features`, kernel 1 once per level) and fetched.

    images: the scan's staged frames (N, H, W) (row k = dataset frame
    frame_offset + k, as results' rows); results: its FrameResult
    (tensors or arrays); fcfg: the FrontendConfig.
    """
    from vislam_tpu_torch.frontend.descriptor import DescriptorGeometry
    from vislam_tpu_torch.frontend.features import extract_features

    is_kf, R_wc, p_wc = to_host(results.is_keyframe, results.R_wc, results.p_wc)
    if geom is None:
        geom = DescriptorGeometry(images.device)
    recs = []
    for k in np.nonzero(is_kf > 0.5)[0]:
        f = extract_features(images[int(k)].to(torch.float32), fcfg, geom)
        recs.append(record_from_feat(frame_offset + int(k), R_wc[k], p_wc[k], f))
    return recs

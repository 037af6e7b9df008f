"""Command-line runner (port of `vislam_tpu/cli.py`): a dataset or a
synthetic sequence through the engine, the trajectory written as CSV (and
TUM), the wall time, the stage report and the ATE printed.

    python -m vislam_tpu_torch.cli --synthetic 60
    python -m vislam_tpu_torch.cli --dataset <dir> [--format euroc|tum|kitti]
                                   [--calibration x.xml] [--scan] [--cpu]
    python -m vislam_tpu_torch.cli --synthetic 86 --loop-correct [--loop-sim3]
                                   [--save-map m.npz | --load-map m.npz --reloc]

The engine runs on the card ("cuda") unless --cpu is given; with no card
and no --cpu the run stops with an error, nothing falls back.

The host loop is pipelined: each frame is dispatched with
`VIOEngine.step_pipelined` (no host feedback between frames: the GT scale's
last-keyframe position rides a device carry), and the packed (37,) results
of PIPE_BURST frames are fetched together, one `torch.stack(...).cpu()`,
the loop's only wait on the card. Keyframe bookkeeping, checkpoints and the
divergence guard run on the fetched rows, up to PIPE_BURST frames behind the
dispatch head; the guard re-anchors the head state with the head image.
Dataset frames are read ahead by a worker thread and, on the card, handed
over in pinned memory as uint8 (copied without waiting, cast on the card;
a distorted camera's remap runs there too).

The map (`backend/`): with --loop-correct, --reloc or --save-map each
keyframe's pose and fine-level features are copied to the host archive as
its row is processed (one copy, after the burst's fetch; --scan
re-extracts them from the staged images, for --loop-correct). --reloc
tries to relocalize against the archive (and a --load-map map) after 3
frames in a row with < 20 matches, and re-anchors the head state with the
head image on success, as the divergence guard does. After the run,
--loop-correct corrects the keyframe rows by an SE(3) (or --loop-sim3
Sim(3)) pose graph and --save-map writes the archive. Without these flags
the loop does nothing more per frame.

Every step option of the reference's CLI runs: --oriented descriptors,
--photometric refine, --gauge ends|oldest2|marg of the window BA.

--dist-ba N refines the final keyframe window after the run with the
landmarks sharded over N ranks (`engine/refine.py::refine_window_distributed`,
`parallel/`) and patches the trailing keyframe rows. Under torchrun the
ranks are torchrun's (N must equal WORLD_SIZE; rank 0 writes the files);
otherwise the CLI spawns N ranks and hands each the final state. NCCL
when each rank has a card of its own, else gloo with the ranks sharing
the card; gloo on the CPU only with --cpu. A line names the backend and
each rank's device.

--plot PREFIX writes PREFIX_traj.png and PREFIX_state.png from the
trajectory CSV after the run; --live-viz PREFIX rewrites PREFIX_live.png
(the trajectory so far) every few keyframes during it (`viz/`; both need
matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from collections import deque

import numpy as np
import torch

# Frames whose packed results the host loop fetches in one copy.
PIPE_BURST = 4


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m vislam_tpu_torch.cli",
                                 description="visual-inertial SLAM on an NVIDIA card")
    ap.add_argument("--dataset", help="dataset sequence directory")
    ap.add_argument("--format", default="euroc", choices=["euroc", "kitti", "tum"],
                    help="dataset directory layout")
    ap.add_argument("--sequence", default="00", help="KITTI sequence id")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run on a generated synthetic sequence of N frames")
    ap.add_argument("--calibration", default=None,
                    help="euroc | kitti | tum | path to an OpenCV-XML file "
                         "(default: matches --format)")
    ap.add_argument("--vision-rotation", action="store_true",
                    help="rotation from the essential matrix instead of the IMU "
                         "(on by force for KITTI)")
    ap.add_argument("--output", default="outputVISlam.csv", help="trajectory CSV")
    ap.add_argument("--start", type=int, default=None, help="first frame index")
    ap.add_argument("--end", type=int, default=None, help="last frame index (excl)")
    ap.add_argument("--gt-scale", action="store_true", default=True,
                    help="monocular scale from the GT translation norm (the default)")
    ap.add_argument("--imu-scale", dest="gt_scale", action="store_false",
                    help="scale from the IMU (GT-free): SLAM mode unless --open-loop")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--scan", action="store_true",
                    help="offline mode (datasets): stage all frames on the device "
                         "and run them as one sequence loop")
    ap.add_argument("--output-tum", default=None, metavar="PATH.txt",
                    help="also write the trajectory in TUM format")
    ap.add_argument("--ba", action="store_true",
                    help="window bundle adjustment inside the step on keyframes")
    ap.add_argument("--open-loop", action="store_true",
                    help="no window BA in GT-free (--imu-scale) runs")
    ap.add_argument("--vi-ba", action="store_true",
                    help="IMU factors in the window BA (implies --ba)")
    ap.add_argument("--gauge", default=None, choices=["marg", "ends", "oldest2"],
                    help="window BA gauge: ends (default), oldest2 (slot 0 + the widest "
                         "baseline; with IMU factors slot 0), marg (marginalization prior)")
    ap.add_argument("--detector", default="shi_tomasi",
                    choices=["shi_tomasi", "harris", "dog", "hessian", "fast"],
                    help="corner/blob response family")
    ap.add_argument("--scale-space", default="gaussian", choices=["gaussian", "nonlinear"],
                    help="Gaussian pyramid or nonlinear (FED) scale space")
    ap.add_argument("--descriptor", default="sift", choices=["sift", "brief"],
                    help="SIFT-128 or BRIEF-256")
    ap.add_argument("--checkpoint", default=None,
                    help="engine-state checkpoint (.npz), saved on every keyframe "
                         "and at the end of a synthetic run")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint at its frame index")
    ap.add_argument("--reloc", action="store_true",
                    help="relocalize against the keyframe archive after a visual outage "
                         "(host-loop modes): place recognition + PnP snap the drifted "
                         "pose back onto the map")
    ap.add_argument("--loop-correct", action="store_true",
                    help="offline loop-closure detection + pose-graph correction after "
                         "the run")
    ap.add_argument("--loop-sim3", action="store_true",
                    help="use a 7-DoF Sim(3) pose graph for --loop-correct (distributes "
                         "monocular scale drift along the trajectory)")
    ap.add_argument("--save-map", default=None, metavar="PATH.npz",
                    help="save the keyframe archive (map) after the run for later "
                         "--load-map sessions")
    ap.add_argument("--load-map", default=None, metavar="PATH.npz",
                    help="preload a saved keyframe map: --reloc localizes against it "
                         "from frame one and --loop-correct sees its keyframes too")
    ap.add_argument("--photometric", action="store_true",
                    help="photometric (direct) refinement of each frame's relative pose")
    ap.add_argument("--oriented", action="store_true",
                    help="rotation-invariant descriptors (sampled in each keypoint's "
                         "orientation frame)")
    ap.add_argument("--dist-ba", type=int, default=0, metavar="N",
                    help="after the run, refine the final keyframe window with the "
                         "landmarks sharded over N ranks (torchrun's, else spawned)")
    ap.add_argument("--plot", default=None, metavar="PREFIX",
                    help="write trajectory/state plots with this path prefix (matplotlib)")
    ap.add_argument("--live-viz", default=None, metavar="PREFIX",
                    help="live observability: atomically rewrite PREFIX_live.png (the "
                         "trajectory so far) every few keyframes during the run (matplotlib)")
    return ap


def main(argv=None, report: dict | None = None) -> int:
    """Run the CLI. `report`, if given, receives the run's figures: rows,
    wall (s), frames, the stage timer (its "drain" stage: one call per
    burst fetched), read_s / frames_read (the loader thread's), the ATE,
    the keyframe archive and the loop correction's info (None unless
    --loop-correct ran it)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint")
    if not args.synthetic and not args.dataset:
        ap.error("either --dataset or --synthetic is required")
    from vislam_tpu_torch.engine.engine import require_device

    try:
        device = require_device("cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"{ap.prog}: error: {e} (or pass --cpu)", file=sys.stderr)
        return 1
    if args.dist_ba and "WORLD_SIZE" in os.environ:
        # Under torchrun: the refine runs over torchrun's ranks.
        if args.dist_ba != int(os.environ["WORLD_SIZE"]):
            ap.error(f"--dist-ba {args.dist_ba} under torchrun needs WORLD_SIZE "
                     f"{args.dist_ba}, not {os.environ['WORLD_SIZE']}")
        import torch.distributed as dist

        from vislam_tpu_torch.parallel.mesh import distributed_init

        created = not dist.is_initialized()      # else the caller's group, kept
        distributed_init(device=device.type)
        try:
            return _run(args, device, {} if report is None else report)
        finally:
            if created:
                dist.destroy_process_group()
    return _run(args, device, {} if report is None else report)


def _with_frontend(args, cfg, use_vi_ba):
    """The detector / descriptor / scale-space / orientation, photometric
    refine, VI-BA and gauge choices on cfg."""
    if (args.detector, args.descriptor, args.oriented, args.scale_space) != (
            "shi_tomasi", "sift", False, "gaussian"):
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, detector=args.detector, descriptor=args.descriptor,
            oriented=args.oriented, scale_space=args.scale_space))
    if args.photometric:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, photometric_refine=True))
    backend = {}
    if use_vi_ba:
        backend["vi_factors"] = True
    if args.gauge:
        backend["online_gauge"] = args.gauge
    if args.ba:
        # The window BA inside the step on keyframes: no state feedback
        # through the host, so the loop stays pipelined.
        backend["refine_in_step"] = True
    return dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, **backend)) \
        if backend else cfg


def _dist_refine(n, state, eng, rows, timer, report):
    """--dist-ba N: the final window refined with its landmarks sharded
    over N ranks (torchrun's group, else N spawned ranks handed the state
    as CPU tensors); an accepted refine patches the trailing keyframe
    rows with the window's positions. Returns the state; the report gets
    "dist_ba": the info, the backend, each rank's device and, from
    spawned ranks, each rank's kernel launches and what each was handed
    (refine_window_rank's arguments but the device type)."""
    import torch.distributed as dist

    from vislam_tpu_torch.engine.refine import refine_window_distributed
    from vislam_tpu_torch.engine.state import tree_to
    from vislam_tpu_torch.parallel.mesh import Ranks, make_mesh, refine_window_rank

    c = eng.calib
    intrinsics = (c.fx, c.fy, c.cx, c.cy)
    if dist.is_initialized():
        backend, devices, launches, handed = dist.get_backend(), [str(eng.device)], None, None
        print(f"distributed window BA: backend {backend}, rank {dist.get_rank()} of "
              f"{dist.get_world_size()} on {eng.device}")
        with timer.stage("dist_ba.refine"):
            state, info = refine_window_distributed(
                state, eng.cfg, *intrinsics, mesh=make_mesh(n, device_type=eng.device.type),
                R_bc=eng.R_bc)
    else:
        with timer.stage("dist_ba.start"):
            ranks = Ranks(n, device=eng.device.type)
        handed = (tree_to(state, "cpu"), eng.cfg, intrinsics, eng.R_bc.cpu())
        with ranks:
            print(f"distributed window BA: {ranks.describe()}")
            with timer.stage("dist_ba.refine"):
                out = ranks.run(refine_window_rank, *handed, eng.device.type)
        backend, devices = ranks.backend, ranks.devices
        launches = [o[2] for o in out]
        new, info, _ = out[0]
        state = tree_to(new, eng.device)
    print(f"distributed window BA (mesh={n} devices): cost {float(info['initial_cost']):.4f} "
          f"-> {float(info['final_cost']):.4f} "
          f"({'accepted' if info['accepted'] else 'rejected'})")
    report["dist_ba"] = dict(info=info, backend=backend, devices=devices, launches=launches,
                             handed=handed)
    if info["accepted"] and rows:
        # The window's refined poses patch the trailing keyframe rows.
        win = state.window
        count = int(win.count)
        kf_rows = [r for r in rows if r["is_kf"]]
        n_back = min(count, len(kf_rows))
        R_cw, t_cw = win.R_cw.cpu().numpy(), win.t_cw.cpu().numpy()
        for i in range(n_back):
            slot = count - n_back + i
            kf_rows[len(kf_rows) - n_back + i]["est_p"] = -R_cw[slot].T @ t_cw[slot]
    return state


def _run(args, device, report) -> int:
    import torch.distributed as dist

    from vislam_tpu_torch import lie
    from vislam_tpu_torch.calib import (
        compute_undistort_maps, euroc_calib, kitti_calib, load_opencv_xml, remap_bilinear,
        tum_calib,
    )
    from vislam_tpu_torch.engine import (
        VIOEngine, run_sequence_scan, stage_dataset, unpack_host_result,
    )
    from vislam_tpu_torch.eval import (
        ate_rmse, smooth_bootstrap_prefix, write_trajectory_csv, write_trajectory_tum,
    )
    from vislam_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_checkpoint_meta, save_checkpoint,
    )
    from vislam_tpu_torch.utils.config import SystemConfig
    from vislam_tpu_torch.utils.timing import StageTimer

    # GT-free runs default to SLAM mode (the window VI-BA, 'ends' gauge);
    # --open-loop opts out. IMU factors whenever the BA runs GT-free.
    if not args.gt_scale and not args.open_loop:
        args.vi_ba = True
    use_vi_ba = args.vi_ba or (args.ba and not args.gt_scale)
    args.ba = args.ba or args.vi_ba
    cfg = _with_frontend(args, SystemConfig(), use_vi_ba)

    timer = StageTimer()
    writes = not dist.is_initialized() or dist.get_rank() == 0   # torchrun: rank 0
    rows, est_positions, gt_positions = [], [], []
    shadow_track, apply_track = [], []
    pending = deque()
    loader = None
    last_good = {"R": None, "p": None}
    kf_archive, outage, loop_info = [], {"n": 0}, None
    if args.load_map:
        from vislam_tpu_torch.backend.mapio import load_map

        kf_archive.extend(load_map(args.load_map))
        print(f"loaded map: {len(kf_archive)} keyframes from {args.load_map}")
    live = None
    if args.live_viz and writes:
        from vislam_tpu_torch.viz import LiveViz

        live = LiveViz(args.live_viz)

    def save_ckpt(state, frame_index, last_kf, last_kf_pos=None):
        if not args.checkpoint or not writes:
            return
        with timer.stage("checkpoint.save"):
            save_checkpoint(args.checkpoint, state, frame_index, meta={
                "last_kf": int(last_kf),
                "last_kf_pos": None if last_kf_pos is None
                else [float(x) for x in np.asarray(last_kf_pos)],
            })

    def load_ckpt():
        state, fidx = load_checkpoint(args.checkpoint, device=device)
        print(f"resumed from {args.checkpoint} at frame {fidx}")
        return state, fidx, load_checkpoint_meta(args.checkpoint)

    def anchored(state, res):
        """A frame's row once the head state was re-anchored: its pose, a
        keyframe."""
        q = state.q_wb.cpu()
        return res._replace(p_wc=state.p_wc.cpu().numpy(), q_wb=q.numpy(), is_keyframe=True,
                            rpy=lie.quat_to_rpy(q).numpy())

    def maybe_recover(eng, state, image, res, frame_index):
        """Divergence guard: a non-finite pose re-anchors the head state at
        the last finite pose (relocalize restarts the window and clears
        non-finite velocity and biases)."""
        if np.isfinite(res.p_wc).all():
            last_good["R"], last_good["p"] = res.R_wc, res.p_wc
            return state, res
        if last_good["p"] is None:
            return state, res
        print(f"divergence at frame {frame_index}: non-finite pose; "
              f"re-anchoring at last good pose")
        state = eng.relocalize(state, image, last_good["R"], last_good["p"])
        return state, anchored(state, res)

    def archive_keyframe(st, frame_index):
        """The keyframe's pose and fine-level features into the archive."""
        if not (args.loop_correct or args.reloc or args.save_map):
            return
        from vislam_tpu_torch.backend.trajectory_opt import record_from_feat

        with timer.stage("map.archive"):
            kf_archive.append(record_from_feat(frame_index, st.kf_R_wc, st.kf_p_wc,
                                               st.kf_feat))

    def maybe_relocalize(eng, state, image, res):
        """After >= 3 frames in a row with < 20 matches, try to snap the head
        state back onto the map with the head image (backend/reloc.py).
        Returns the state, re-anchored where that succeeded."""
        if not args.reloc:
            return state
        if res.num_matches >= 20:
            outage["n"] = 0
            return state
        outage["n"] += 1
        if outage["n"] < 3 or len(kf_archive) < 2:
            return state
        from vislam_tpu_torch.backend.reloc import attempt_relocalization
        from vislam_tpu_torch.frontend.features import extract_features

        c = eng.calib
        with timer.stage("reloc.attempt"):
            f = extract_features(torch.as_tensor(image).to(eng.device, torch.float32),
                                 eng.cfg.frontend, eng.geom)
            r = attempt_relocalization(f.uv, f.desc, f.mask, kf_archive, c.fx, c.fy, c.cx, c.cy,
                                       device=eng.device)
        if not r.success:
            return state
        print(f"relocalized against keyframe {kf_archive[r.kf_index].frame_index} "
              f"({r.n_inliers} inliers, rmse {r.rmse:.2f} px)")
        outage["n"] = 0
        return eng.relocalize(state, image, r.R_wc, r.p_wc)

    def drain(process):
        """Fetch every pending frame's packed result in one copy, then
        process them in order (the head image rides with the last)."""
        if not pending:
            return
        with timer.stage("drain"):
            flats = torch.stack([item[-1] for item in pending]).cpu().numpy()
        items = list(pending)
        pending.clear()
        head_img = items[-1][1]
        for row, item in zip(flats, items):
            process(item, head_img, unpack_host_result(row))

    def track(res):
        est_positions.append(np.asarray(res.p_wc))
        shadow_track.append(np.asarray(res.shadow_p_wc))
        apply_track.append(int(res.bootstrap_applies))

    def row(frame, t_ns, res, gt_p=None, gt_rpy=None, gt_q=None, gt_v=None):
        return dict(frame=frame, t_ns=int(t_ns), is_kf=bool(res.is_keyframe),
                    est_p=np.asarray(res.p_wc), est_rpy=np.asarray(res.rpy),
                    est_q=np.asarray(res.q_wb), est_v=np.asarray(res.v_w),
                    gt_p=gt_p, gt_rpy=gt_rpy, gt_q=gt_q, gt_v=gt_v)

    def warm_up(eng, state, *step_args):
        """One discarded step before the timed loop (first-use kernel builds
        and loads, allocator growth), its draw counter restored."""
        counter = eng._step_counter
        with timer.stage("warm_up"):
            eng.step_pipelined(state, *step_args)[-1].cpu()
        eng.set_step_counter(counter)

    if args.synthetic:
        from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence

        seq = make_synthetic_sequence(
            SyntheticConfig(n_frames=args.synthetic, n_landmarks=300, seed=0))
        calib = seq["calib"]
        eng = VIOEngine(calib, cfg, device=device)
        state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                               v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
        last_kf, start_j = 0, 1
        if args.resume:
            state, fidx, meta = load_ckpt()
            start_j = fidx + 1
            last_kf = int(meta.get("last_kf", fidx))
            eng.set_step_counter(fidx)   # the same per-frame draws
        kf_gt_pos = np.asarray(seq["gt_pos"][last_kf], np.float32)
        gt_on = 1.0 if args.gt_scale else 0.0
        pin = device.type == "cuda"

        def frame_inputs(j):
            lo, hi = (j - 1) * 10, j * 10
            imu = np.zeros((16, 6), np.float32)
            imu[:10] = np.concatenate([seq["imu_gyro"][lo:hi], seq["imu_accel"][lo:hi]], -1)
            dt = np.zeros(16, np.float32)
            dt[:10] = 1 / 200.0
            img = torch.from_numpy(seq["images"][j])
            return (img.pin_memory() if pin else img), imu, dt

        def process(item, head_img, res):
            nonlocal state, last_kf, kf_gt_pos
            j, _, st_j, _ = item
            if res.is_keyframe:
                last_kf = j
                archive_keyframe(st_j, j)
                save_ckpt(st_j, j, last_kf)
            state, res = maybe_recover(eng, state, head_img, res, j)
            new = maybe_relocalize(eng, state, head_img, res)
            if new is not state:
                state, last_kf = new, j
                kf_gt_pos = np.asarray(seq["gt_pos"][j], np.float32)
                res = anchored(state, res)
            track(res)
            gt_positions.append(seq["gt_pos"][j])
            if live is not None:
                live.update(j, res.p_wc, seq["gt_pos"][j], bool(res.is_keyframe))
            rows.append(row(j, seq["t_cam_ns"][j], res, seq["gt_pos"][j], seq["gt_rpy"][j],
                            seq["gt_quat"][j], seq["gt_vel"][j]))

        if start_j < args.synthetic:
            img, imu, dt = frame_inputs(start_j)
            warm_up(eng, state, kf_gt_pos, img, np.zeros_like(imu), np.zeros_like(dt),
                    seq["gt_pos"][start_j], gt_on)
        t0 = time.perf_counter()
        for j in range(start_j, args.synthetic):
            img, imu, dt = frame_inputs(j)
            with timer.stage("engine.step"):
                state, kf_gt_pos, flat = eng.step_pipelined(
                    state, kf_gt_pos, img, imu, dt, seq["gt_pos"][j], gt_on)
            pending.append((j, img, state, flat))
            if len(pending) >= PIPE_BURST:
                drain(process)
        drain(process)
        wall = time.perf_counter() - t0
        save_ckpt(state, args.synthetic - 1, last_kf)
    else:
        from vislam_tpu_torch.data import (
            EurocDataset, KittiDataset, PrefetchLoader, TumDataset,
        )
        from vislam_tpu_torch.inertial import calibrate_gyro_bias, static_mask

        calib_name = args.calibration or args.format
        presets = {"euroc": euroc_calib, "kitti": kitti_calib, "tum": tum_calib}
        calib = presets[calib_name]() if calib_name in presets else load_opencv_xml(calib_name)
        if args.format == "kitti":
            ds = KittiDataset(args.dataset, args.sequence)
        elif args.format == "tum":
            ds = TumDataset(args.dataset)
        else:
            ds = EurocDataset(args.dataset)
        start = ds.start_index if args.start is None else args.start
        end = len(ds) if args.end is None else args.end

        # Gyro bias from the stationary IMU prefix (EuRoC).
        bias_g = None
        if hasattr(ds, "static_imu_prefix"):
            g_pre, a_pre = ds.static_imu_prefix(2.5)
            if len(g_pre) > 50:
                g_t = torch.from_numpy(g_pre)
                bias_g = calibrate_gyro_bias(g_t, static_mask(g_t, torch.from_numpy(a_pre)))

        if args.vision_rotation or args.format == "kitti":
            # The 8-point solve needs fine keypoints: single scale.
            cfg = dataclasses.replace(
                cfg, engine=dataclasses.replace(cfg.engine, vision_rotation=True),
                frontend=dataclasses.replace(cfg.frontend, levels_used=1))

        # A distorted camera: the maps once on the host, the remap on the
        # device every frame; the engine runs on the rectified intrinsics.
        undistort = None
        if calib.has_distortion:
            with timer.stage("undistort.precompute"):
                maps, calib = compute_undistort_maps(calib)
            maps_d = torch.from_numpy(maps).to(device)

            def undistort(img):
                return remap_bilinear(torch.as_tensor(img).to(device, non_blocking=True),
                                      maps_d)

        eng = VIOEngine(calib, cfg, device=device)
        fw0 = ds.frame_window(start)
        img0 = fw0.image if undistort is None else undistort(fw0.image)
        gt_q0 = fw0.gt_quat if fw0.gt_quat is not None else np.array([1.0, 0, 0, 0])
        gt_p0 = fw0.gt_pos if fw0.gt_pos is not None else np.zeros(3)
        gt_v0 = fw0.gt_vel if fw0.gt_vel is not None else np.zeros(3)
        state = eng.initialize(img0, q_wb0=gt_q0, v_w0=gt_v0, p_w0=gt_p0)
        if bias_g is not None:
            state = state._replace(bias_g=bias_g.to(device))

        if args.scan:
            with timer.stage("scan.stage"):
                inputs = stage_dataset(ds, start + 1, end, use_gt_scale=args.gt_scale,
                                       undistort=undistort, device=device)
            with timer.stage("scan.run"):
                state, results = run_sequence_scan(eng, state, inputs, kf_gt_pos0=gt_p0)
                rpy_all = lie.quat_to_rpy(results.q_wb).cpu().numpy()
                res_np = type(results)(*[x.cpu().numpy() for x in results])
            wall = timer.total["scan.run"]
            gt_pos_np = inputs.gt_pos.cpu().numpy()
            for k in range(res_np.p_wc.shape[0]):
                j = start + 1 + k
                est_positions.append(res_np.p_wc[k])
                gtp = gt_pos_np[k] if inputs.use_gt_scale else None
                if gtp is not None:
                    gt_positions.append(gtp)
                rows.append(dict(frame=j, t_ns=int(ds.image_t_ns[j]),
                                 is_kf=bool(res_np.is_keyframe[k]), est_p=res_np.p_wc[k],
                                 est_rpy=rpy_all[k], est_q=res_np.q_wb[k], est_v=res_np.v_w[k],
                                 gt_p=gtp, gt_rpy=None, gt_q=None, gt_v=None))
            if args.loop_correct:
                # The scan carries no features: the keyframes' are extracted
                # again from the staged images.
                from vislam_tpu_torch.backend.trajectory_opt import keyframes_from_scan

                with timer.stage("loop.archive"):
                    kf_archive.extend(keyframes_from_scan(inputs.images, res_np,
                                                          eng.cfg.frontend, start + 1,
                                                          geom=eng.geom))
        else:
            last_kf_pos = gt_p0
            loop_start = start + 1
            if args.resume:
                state, fidx, meta = load_ckpt()
                loop_start = fidx + 1
                if meta.get("last_kf_pos") is not None:
                    last_kf_pos = np.asarray(meta["last_kf_pos"], np.float64)
                eng.set_step_counter(fidx - start)   # the same per-frame draws
            kf_gt_pos = np.asarray(last_kf_pos, np.float32)

            def process(item, head_img, res):
                nonlocal state, last_kf_pos, kf_gt_pos
                fw = item[0]
                if res.is_keyframe:
                    if fw.gt_pos is not None:
                        last_kf_pos = fw.gt_pos
                    archive_keyframe(item[2], fw.index)
                    save_ckpt(item[2], fw.index, fw.index, last_kf_pos=last_kf_pos)
                state, res = maybe_recover(eng, state, head_img, res, fw.index)
                new = maybe_relocalize(eng, state, head_img, res)
                if new is not state:
                    state = new
                    if fw.gt_pos is not None:
                        last_kf_pos = fw.gt_pos
                        kf_gt_pos = np.asarray(fw.gt_pos, np.float32)
                    res = anchored(state, res)
                track(res)
                if fw.gt_pos is not None:
                    gt_positions.append(fw.gt_pos)
                if live is not None:
                    live.update(fw.index, res.p_wc, fw.gt_pos, bool(res.is_keyframe))
                gt_rpy = None if fw.gt_quat is None else lie.quat_to_rpy(
                    torch.as_tensor(fw.gt_quat, dtype=torch.float32)).numpy()
                rows.append(row(fw.index, fw.t_ns, res, fw.gt_pos, gt_rpy, fw.gt_quat,
                                fw.gt_vel))

            def frame_gt(fw):
                has_gt = args.gt_scale and fw.gt_pos is not None
                return (fw.gt_pos if fw.gt_pos is not None else np.zeros(3),
                        1.0 if has_gt else 0.0)

            if loop_start < end:
                fw = ds.frame_window(loop_start)
                warm_up(eng, state, kf_gt_pos, fw.image if undistort is None
                        else undistort(fw.image), fw.imu, fw.imu_dt, *frame_gt(fw))
            loader = PrefetchLoader(ds, start=loop_start, end=end,
                                    pin_memory=device.type == "cuda")
            t0 = time.perf_counter()
            for fw in loader:
                img_in = fw.image
                if undistort is not None:
                    with timer.stage("undistort"):
                        img_in = undistort(img_in)
                with timer.stage("engine.step"):
                    state, kf_gt_pos, flat = eng.step_pipelined(
                        state, kf_gt_pos, img_in, fw.imu, fw.imu_dt, *frame_gt(fw))
                pending.append((fw, img_in, state, flat))
                if len(pending) >= PIPE_BURST:
                    drain(process)
            drain(process)
            wall = time.perf_counter() - t0

    if args.dist_ba:
        state = _dist_refine(args.dist_ba, state, eng, rows, timer, report)
    if args.loop_correct and len(kf_archive) > 10:
        from vislam_tpu_torch.backend.trajectory_opt import correct_trajectory

        c = eng.calib
        with timer.stage("loop.correct"):
            p_corr, _, loop_info = correct_trajectory(kf_archive, c.fx, c.fy, c.cx, c.cy,
                                                      use_sim3=args.loop_sim3, device=device)
        print(f"loop closures: {loop_info['loops']}")
        if loop_info["loops"]:
            # The corrected keyframe positions replace their rows'.
            by_frame = {k.frame_index: i for i, k in enumerate(kf_archive)}
            for r in rows:
                i = by_frame.get(r["frame"])
                if i is not None:
                    r["est_p"] = p_corr[i]
    if live is not None:
        out_png = live.close()
        if out_png:
            print(f"live snapshot: {out_png}")
    if args.save_map and kf_archive and writes:
        from vislam_tpu_torch.backend.mapio import save_map

        save_map(args.save_map, kf_archive)
        print(f"map saved: {len(kf_archive)} keyframes to {args.save_map}")
    if writes:
        write_trajectory_csv(args.output, rows)
    if args.output_tum and writes:
        write_trajectory_tum(args.output_tum, rows)
        print(f"TUM-format trajectory written to {args.output_tum}")
    n = len(rows)
    print(f"processed {n} frames in {wall:.2f}s ({n / max(wall, 1e-9):.1f} fps)")
    print(timer.report())
    if loader is not None and loader.frames_read:
        print(f"frame read (PNG decode + IMU/GT slicing, loader thread): "
              f"{1e3 * loader.read_seconds / loader.frames_read:.3f} ms per frame")
    smoothed = None
    if (not args.gt_scale and len(shadow_track) == len(est_positions)
            and apply_track and apply_track[-1] > 0):
        smoothed = smooth_bootstrap_prefix(
            np.array(est_positions), np.array(shadow_track), np.array(apply_track),
            state.origin_p_wc.cpu().numpy(), state.shadow_origin_p.cpu().numpy())
        print(f"bootstrap smoothing: re-anchored prefix rewritten "
              f"({apply_track[-1]} applies)")
    ate = None
    if gt_positions and len(gt_positions) == len(est_positions):
        est, gt = np.array(est_positions), np.array(gt_positions)
        ate = ate_rmse(est, gt, align=False)
        print(f"ATE RMSE (unaligned): {ate:.4f} m")
        print(f"ATE RMSE (SE3-aligned): {ate_rmse(est, gt):.4f} m")
        if smoothed is not None:
            print(f"ATE RMSE (bootstrap-smoothed, unaligned): "
                  f"{ate_rmse(smoothed, gt, align=False):.4f} m")
    print(f"trajectory written to {args.output}")
    if args.plot and writes:
        from vislam_tpu_torch.eval import read_trajectory_csv
        from vislam_tpu_torch.viz import plot_state_comparison, plot_trajectory

        traj = read_trajectory_csv(args.output)
        plot_trajectory(traj, args.plot + "_traj.png")
        plot_state_comparison(traj, args.plot + "_state.png")
        print(f"plots written to {args.plot}_traj.png / _state.png")
    report.update(rows=rows, wall=wall, frames=n, timer=timer, ate=ate,
                  read_s=loader.read_seconds if loader else 0.0,
                  frames_read=loader.frames_read if loader else 0,
                  archive=kf_archive, loop_info=loop_info)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of vislam_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc, the TF32 flags;
  1. build: every CUDA kernel from vislam_tpu_torch/ops/csrc/, one nvcc per
     source, all started together;
  2. kernels: each kernel, and each response family, against its plain
     PyTorch twin on the card at the shapes its path gives it, with the
     tests' tolerances; both timed with CUDA events (plain, kernel, kernel,
     plain);
  3. paths: run_sequence_scan over a 480x752 synthetic sequence with GT
     scale, K = 768, for each frontend the port runs:
       default  SystemConfig() (Shi-Tomasi, SIFT), 60 frames
       kaze     nonlinear scale space + hessian, 60 frames
       akaze    nonlinear scale space + fast + BRIEF-256, 60 frames
       harris   harris detector, 10 frames
       dog      dog detector, 10 frames
     Each path resets every launch counter just before its run and reads
     them just after; it fails unless each of its kernels ran exactly the
     expected times per frame. Each checks finite poses, prints frames/s
     and the host syncs left inside a step (sync debug mode), and runs its
     first 10 frames again on the CPU (plain twins, same random draws) as
     the reference the card must agree with. default and kaze also hold
     ATE < 0.5 m, > 5 keyframes and > 90% of frames solved; the akaze
     analog does not track on this sequence in the reference either, so
     it has no accuracy bound. The 60-frame paths print where a frame's
     time goes (wall time per stage, device busy share and kernels by
     device time from torch.profiler).

The last two lines are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

DEV = "cuda"
N_FRAMES = 60      # frames of the 60-frame paths
N_SHORT = 10       # frames of the short paths and of each CPU reference

# frontend overrides, frames, whether accuracy is checked, and the launches
# per frame each kernel (counter name) must show on that path
PATHS = {
    "default": (dict(), N_FRAMES, True, {"shi_tomasi": 2, "match_top2": 2}),
    "kaze": (dict(scale_space="nonlinear", detector="hessian"), N_FRAMES, True,
             {"fed_evolve": 2, "hessian": 2, "_gradmag2": 1, "match_top2": 2}),
    "akaze": (dict(scale_space="nonlinear", detector="fast", descriptor="brief"),
              N_FRAMES, False,
              {"fed_evolve": 2, "fast": 2, "_gradmag2": 1, "match_top2": 2}),
    "harris": (dict(detector="harris"), N_SHORT, False, {"harris": 2, "match_top2": 2}),
    "dog": (dict(detector="dog"), N_SHORT, False, {"dog": 2, "match_top2": 2}),
}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(plain, kernel):
    """Mean times of (kernel, plain) measured in turns plain, kernel,
    kernel, plain within one process on one card."""
    p1 = _time_ms(plain)
    k1 = _time_ms(kernel)
    k2 = _time_ms(kernel)
    p2 = _time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _counters():
    """name -> (object whose `launches` holds the count, key or None)."""
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve
    from vislam_tpu_torch.ops.harris_kernel import FAMILIES, response_nms
    from vislam_tpu_torch.ops.match_kernel import match_top2

    out = {fam: (response_nms, fam) for fam in FAMILIES}
    out["fed_evolve"] = (fed_evolve, None)
    out["match_top2"] = (match_top2, None)
    return out


def reset_launches() -> None:
    for obj, key in _counters().values():
        if key is None:
            obj.launches = 0
        else:
            obj.launches[key] = 0


def read_launches() -> dict:
    return {name: (obj.launches if key is None else obj.launches[key])
            for name, (obj, key) in _counters().items()}


def _frontend(**overrides):
    from vislam_tpu_torch.utils.config import SystemConfig

    base = SystemConfig()
    return dataclasses.replace(base, frontend=dataclasses.replace(base.frontend, **overrides))


def _response_rows(seq):
    """Every response family against its plain twin on its path's levels."""
    from vislam_tpu_torch.frontend.nonlinear import nonlinear_scale_space
    from vislam_tpu_torch.frontend.pyramid import build_pyramid
    from vislam_tpu_torch.ops.harris_kernel import response_nms, response_nms_plain

    img = torch.as_tensor(seq["images"][1]).to(DEV, torch.float32)
    # The levels each detector sees: the bf16 Gaussian pyramid widened to
    # float32 (shi_tomasi, harris, dog), the float32 nonlinear levels
    # (hessian, fast), and the frame itself (_gradmag2).
    gauss = [lv.float().contiguous() for lv in build_pyramid(img.to(torch.bfloat16), 2)]
    nonlin = [lv.contiguous() for lv in nonlinear_scale_space(img.to(torch.bfloat16), 2)]
    fields = {"shi_tomasi": gauss, "harris": gauss, "dog": gauss, "hessian": nonlin,
              "fast": nonlin, "_gradmag2": [img]}
    rows = []
    for fam, levels in fields.items():
        err_max = t_k = t_p = 0.0
        for lv in levels:
            k_nms, k_resp = response_nms(lv, fam)
            p_nms, p_resp = response_nms_plain(lv[None], fam)
            p_resp = p_resp[0]
            torch.cuda.synchronize()
            err = (k_resp - p_resp).abs().max().item()
            scale = max(p_resp.abs().max().item(), 1.0)
            agree = 1.0 if k_nms is None else \
                (torch.isneginf(k_nms) == torch.isneginf(p_nms[0])).float().mean().item()
            # The tests' bounds (tests/test_ops.py): error / scale < 1e-4,
            # NMS agreement > 0.999 (float32 sums in another order may flip
            # a near-tied maximum).
            if not err / scale < 1e-4 or not agree > 0.999:
                _fail(f"response_nms {fam} disagrees at {tuple(lv.shape)}: max abs err "
                      f"{err} (scale {scale}), nms agreement {agree}")
            tk, tp = _turns(lambda: response_nms_plain(lv[None], fam),
                            lambda: response_nms(lv, fam))
            err_max, t_k, t_p = max(err_max, err), t_k + tk, t_p + tp
            print(f"kernel response_nms {fam} {tuple(lv.shape)}: max_abs_err {err:.3e} "
                  f"(scale {scale:.3e}), nms agreement {agree:.6f}, kernel {tk * 1e3:.1f} us, "
                  f"plain {tp * 1e3:.1f} us", flush=True)
        rows.append(dict(name=f"response_nms:{fam}", counter=fam, route="cuda",
                         source="vislam_tpu_torch/ops/csrc/response_nms.cu",
                         replaces="vislam_tpu/ops/harris_kernel.py:193",
                         max_abs_err=err_max, ms=t_k, plain_ms=t_p))
    return rows


def _fed_row(seq):
    """FED at 480x752: the 4-step cycle on the presmoothed frame and the
    8-step one on level 0, as the nonlinear scale space runs them."""
    from vislam_tpu_torch.frontend.nonlinear import contrast_factor, fed_tau_steps
    from vislam_tpu_torch.frontend.pyramid import gaussian_blur
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve, fed_evolve_plain

    img = torch.as_tensor(seq["images"][1]).to(DEV, torch.bfloat16)
    k = contrast_factor(img)
    L = gaussian_blur(img, 1.0).float().contiguous()
    err_max = t_k = t_p = 0.0
    for T in (0.78, 3.84):
        taus = fed_tau_steps(T)
        out = fed_evolve(L, k, taus)
        ref = fed_evolve_plain(L[None], k.reshape(1), taus)[0]
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # float32 stencils summed in another order, through n steps of a
        # stable diffusion on a 0-255 field: 1e-3 absolute is ~4e-6 relative.
        if not err < 1e-3:
            _fail(f"fed_evolve n={len(taus)} disagrees: max abs err {err}")
        tk, tp = _turns(lambda: fed_evolve_plain(L[None], k.reshape(1), taus),
                        lambda: fed_evolve(L, k, taus))
        err_max, t_k, t_p = max(err_max, err), t_k + tk, t_p + tp
        print(f"kernel fed_evolve n={len(taus)} {tuple(L.shape)} k={k.item():.4f}: max_abs_err "
              f"{err:.3e}, kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us", flush=True)
        L = out
    return dict(name="fed_evolve", counter="fed_evolve", route="cuda",
                source="vislam_tpu_torch/ops/csrc/fed_evolve.cu",
                replaces="vislam_tpu/ops/fed_kernel.py:83", max_abs_err=err_max, ms=t_k,
                plain_ms=t_p)


def _match_rows(seq, gate_px):
    """match_top2 on real descriptors of two frames: SIFT-128 at K = 768
    and 512, BRIEF-256 at K = 768; ungated and gated at the rescue's disc."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.ops.match_kernel import match_top2, match_top2_plain
    from vislam_tpu_torch.utils.config import FrontendConfig

    rows = []
    for D, cfgs in ((128, [FrontendConfig(levels_used=2), FrontendConfig(levels_used=1)]),
                    (256, [FrontendConfig(scale_space="nonlinear", detector="fast",
                                          descriptor="brief")])):
        err_max = 0.0
        t_k = t_p = None
        for fcfg in cfgs:
            fa = extract_features(torch.as_tensor(seq["images"][0]).to(DEV, torch.float32), fcfg)
            fb = extract_features(torch.as_tensor(seq["images"][1]).to(DEV, torch.float32), fcfg)
            K = fa.uv.shape[0]
            for gated in (False, True):
                gate = dict(uv_pred=fa.uv.contiguous(), uv_b=fb.uv.contiguous(),
                            gate_radius=gate_px) if gated else {}
                args = (fa.desc.contiguous(), fa.mask.contiguous(), fb.desc.contiguous(),
                        fb.mask.contiguous())
                k = match_top2(*args, **gate)
                p = match_top2_plain(*args, **gate)
                torch.cuda.synchronize()
                err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
                if D == 128:
                    # SIFT: float32 dot products summed in another order
                    # (rtol 1e-4); indices exact away from near-ties.
                    for name, a, b in (("min1", k[0], p[0]), ("min2", k[1], p[1])):
                        if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                            _fail(f"match_top2 {name} disagrees (K={K}, D={D}, gated={gated}): "
                                  f"max abs err {(a - b).abs().max().item()}")
                    has = p[0] < 5e8
                    rows_ok = has & ((p[1] - p[0]).abs() > 1e-5 * p[0].clamp(min=1e-6))
                    cols_ok = fb.mask
                else:
                    # BRIEF: every distance is an exact multiple of 1/64, so
                    # distances are exact and indices agree on every row and
                    # column, exact ties included.
                    if err != 0.0:
                        _fail(f"match_top2 D=256 distances not exact (gated={gated}): {err}")
                    rows_ok = torch.ones_like(fa.mask)
                    cols_ok = torch.ones_like(fb.mask)
                arg_ok = (k[2] == p[2])[rows_ok].float().mean().item()
                col_ok = (k[3] == p[3])[cols_ok].float().mean().item()
                ties = int(((p[1] == p[0]) & (p[0] < 5e8)).sum().item())
                if arg_ok < 1.0 or col_ok < (0.99 if D == 128 else 1.0):
                    _fail(f"match_top2 indices disagree (K={K}, D={D}, gated={gated}): arg1 "
                          f"{arg_ok}, colarg {col_ok}")
                tk, tp = _turns(lambda: match_top2_plain(*args, **gate),
                                lambda: match_top2(*args, **gate))
                if K == 768:
                    t_k = tk if t_k is None else t_k + tk
                    t_p = tp if t_p is None else t_p + tp
                err_max = max(err_max, err)
                print(f"kernel match_top2 K={K} D={D} gated={gated}: max_abs_err {err:.3e}, "
                      f"arg1 exact {arg_ok:.4f} of {int(rows_ok.sum())} rows ({ties} tied at "
                      f"min1), colarg {col_ok:.4f}, kernel {tk * 1e3:.1f} us, plain "
                      f"{tp * 1e3:.1f} us", flush=True)
        rows.append(dict(name=f"match_top2:d{D}", counter="match_top2", route="cuda",
                         source="vislam_tpu_torch/ops/csrc/match_top2.cu",
                         replaces="vislam_tpu/ops/match_kernel.py:126", max_abs_err=err_max,
                         ms=t_k, plain_ms=t_p))
    return rows


def kernel_phase(seq, cfg_default):
    """Each kernel against its plain twin at main-path shapes and data."""
    # argmin keeps the first index on ties on the card, as on the CPU.
    d = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0], device=DEV)
    if int(torch.argmin(d)) != 1 or int(torch.argmin(d.reshape(5, 1), dim=0)[0]) != 1:
        _fail("torch.argmin does not keep the first index on ties on the card")
    return (_response_rows(seq) + [_fed_row(seq)]
            + _match_rows(seq, cfg_default.frontend.guided_fallback_px))


def profile_path(name, eng, state, inputs):
    """Where a frame's time goes: wall time per stage (each stage alone,
    synchronised), then a torch.profiler pass over 10 frames for the device
    busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from vislam_tpu_torch.engine import run_sequence_scan
    from vislam_tpu_torch.engine.engine import frame_generator
    from vislam_tpu_torch.frontend.detect import detect_keypoints
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors
    from vislam_tpu_torch.frontend.nonlinear import nonlinear_scale_space
    from vislam_tpu_torch.frontend.pose import gumbel_noise, ransac_translation
    from vislam_tpu_torch.frontend.pyramid import build_pyramid
    from vislam_tpu_torch.inertial.filters import madgwick_scan
    from vislam_tpu_torch.inertial.preintegration import preintegrate

    fe = eng.cfg.frontend
    img, imu, dt = inputs.images[5], inputs.imu[5], inputs.imu_dt[5]
    kf = state.kf_feat
    feat = extract_features(img, fe, eng.geom)
    rays = torch.nn.functional.normalize(torch.randn(kf.uv.shape[0], 3, device=DEV), dim=-1)
    noise = gumbel_noise(frame_generator(0, 0, DEV), eng.cfg.backend.ransac_hyps,
                         kf.uv.shape[0], DEV)
    R = torch.eye(3, device=DEV)
    img_t = img.to(getattr(torch, fe.image_dtype))
    n_lv = min(fe.num_levels, fe.levels_used)

    def scale_space():
        if fe.scale_space == "nonlinear":
            return nonlinear_scale_space(img_t, n_lv)
        return build_pyramid(img_t, n_lv)

    pyr = scale_space()

    def wall_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    stages = {
        "inertial (madgwick_scan + preintegrate, 16 samples)": lambda: (
            madgwick_scan(state.q_wb, imu[:, :3], imu[:, 3:], dt),
            preintegrate(imu[:, :3], imu[:, 3:], dt)),
        f"scale space ({fe.scale_space}, {n_lv} levels)": scale_space,
        f"detect_keypoints ({fe.detector})": lambda: detect_keypoints(
            pyr, fe.grid_rows, fe.grid_cols, fe.kp_per_cell_by_level, fe.nms_radius,
            fe.min_score, fe.patch_size // 2 + 4, fe.levels_used, fe.detector),
        f"extract_features (all of it, {fe.descriptor}, K={fe.max_keypoints})":
            lambda: extract_features(img, fe, eng.geom),
        "match_descriptors (ungated)": lambda: match_descriptors(
            kf.desc, kf.mask, feat.desc, feat.mask),
        "ransac_translation (512 x 768)": lambda: ransac_translation(
            rays, rays.roll(1, 0), R, kf.mask, uv_i=kf.uv, dispersion_pow=1.25, noise=noise),
        "whole step": lambda: eng.step(state, img, imu, dt, 0.1),
    }
    lines = [f"{stage}: {wall_ms(fn):.2f} ms wall" for stage, fn in stages.items()]

    sub = inputs._replace(images=inputs.images[:10], imu=inputs.imu[:10],
                          imu_dt=inputs.imu_dt[:10], gt_pos=inputs.gt_pos[:10])
    run_sequence_scan(eng, state, sub)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_sequence_scan(eng, state, sub)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Device rows only: an operator row carries the time of the kernels it
    # launched as well, so summing every row counts each kernel twice.
    dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    lines.append(f"profiled 10 frames: wall {wall * 1e3:.1f} ms, device busy "
                 f"{dev_us / 1e3:.1f} ms ({dev_us / 1e6 / wall:.3f} of wall), "
                 f"{sum(e.count for e in events if e.key.startswith('cudaLaunchKernel'))} "
                 f"kernel launches")
    print(f"profile {name}: " + f"\nprofile {name}: ".join(lines), flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)


def _host_syncs(eng, state, inputs) -> list:
    """Synchronizing calls inside one step under CUDA sync debug mode, each
    located by the port's innermost frame on the Python stack."""
    import traceback
    import warnings

    syncs = []

    def locate(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack() if "vislam_tpu_torch" in f.filename]
            syncs.append(f"{ours[-1].filename.split('vislam_tpu_torch')[-1]}:{ours[-1].lineno}"
                         if ours else "outside the port")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = locate
        torch.cuda.set_sync_debug_mode("warn")
        eng.step(state, inputs.images[0], inputs.imu[0], inputs.imu_dt[0], 0.1)
        torch.cuda.set_sync_debug_mode("default")
    return syncs


def path_phase(name, seq) -> dict:
    """Drive one frontend's path; returns its launch counts."""
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.engine.engine import frame_generator
    from vislam_tpu_torch.eval import ate_rmse
    from vislam_tpu_torch.frontend.pose import gumbel_noise

    overrides, N, accuracy, per_frame = PATHS[name]
    cfg = _frontend(**overrides)
    eng = VIOEngine(seq["calib"], cfg, device=DEV)

    def init(e):
        return e.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                            v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

    inputs = make_sequence_inputs(seq, 1, 1 + N, device=DEV)
    # Warm-up on a short prefix (first-use library loads, allocator growth).
    run_sequence_scan(eng, init(eng), inputs._replace(
        images=inputs.images[:3], imu=inputs.imu[:3], imu_dt=inputs.imu_dt[:3],
        gt_pos=inputs.gt_pos[:3]))
    state0 = init(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    state, res = run_sequence_scan(eng, state0, inputs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    fps = [N / elapsed]
    if N == N_FRAMES:
        # Two more timed runs: the spread of frames/s on this host (the step
        # is bound by the host's dispatch of small launches).
        for _ in range(2):
            t0 = time.perf_counter()
            run_sequence_scan(eng, state0, inputs)
            torch.cuda.synchronize()
            fps.append(N / (time.perf_counter() - t0))

    p = res.p_wc.cpu().numpy()
    kf = res.is_keyframe.cpu().numpy()
    nm = res.num_matches.cpu().numpy()
    ni = res.num_inliers.cpu().numpy()
    if p.shape != (N, 3) or not np.isfinite(p).all():
        _fail(f"{name}: non-finite or misshapen poses {p.shape}")
    poses = np.concatenate([seq["gt_pos"][:1], p])
    ate = ate_rmse(poses, seq["gt_pos"][: N + 1], align=False)
    solved = float(((ni >= 8) & (nm > 50)).mean())
    print(f"path {name}: {N} frames in {elapsed:.3f} s = {N / elapsed:.2f} frames/s "
          f"({overrides or 'default SystemConfig'}, K={cfg.frontend.max_keypoints}, 480x752, "
          f"GT scale); ATE {ate:.4f} m; keyframes {int(kf.sum())}; solved {solved:.3f}; "
          f"median matches {float(np.median(nm)):.0f}, inliers {float(np.median(ni)):.0f}; "
          f"rescues {int(res.used_fallback.sum())}; peak device memory {peak_mb:.1f} MiB; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    if len(fps) > 1:
        print(f"path {name}: frames/s over {len(fps)} runs {[round(f, 2) for f in fps]}, "
              f"median {float(np.median(fps)):.2f}", flush=True)
    if accuracy:
        if not ate < 0.5:
            _fail(f"{name}: ATE {ate} >= 0.5 m")
        if not kf.sum() > 5:
            _fail(f"{name}: only {int(kf.sum())} keyframes")
        if not solved > 0.9:
            _fail(f"{name}: only {solved:.3f} of frames solved")
    for counter, n in per_frame.items():
        if launches[counter] != n * N:
            _fail(f"{name}: {counter} launched {launches[counter]} times over {N} frames "
                  f"(expected {n} per frame)")

    syncs = _host_syncs(eng, state, inputs)
    print(f"path {name}: host syncs inside one step: {len(syncs)} {sorted(set(syncs))}",
          flush=True)
    if syncs:
        _fail(f"{name}: {len(syncs)} host syncs inside a step")

    if N == N_FRAMES:
        profile_path(name, eng, state, inputs)

    # Reference on a small input: the first frames again on the CPU (the
    # plain twins), with the same random draws on both devices.
    n_ref = N_SHORT
    cpu = VIOEngine(seq["calib"], cfg, device="cpu")
    M = cfg.frontend.max_keypoints
    H = cfg.backend.ransac_hyps
    noises = []
    for n in range(n_ref):
        g = frame_generator(0, n, "cpu")
        noises.append((gumbel_noise(g, H, M, "cpu"), gumbel_noise(g, H, M, "cpu")))
    sub = inputs._replace(images=inputs.images[:n_ref], imu=inputs.imu[:n_ref],
                          imu_dt=inputs.imu_dt[:n_ref], gt_pos=inputs.gt_pos[:n_ref])
    _, r_gpu = run_sequence_scan(eng, init(eng), sub,
                                 noises=[(a.to(DEV), b.to(DEV)) for a, b in noises])
    cpu_inputs = sub._replace(**{k: getattr(sub, k).cpu()
                                 for k in ("images", "imu", "imu_dt", "gt_pos")})
    _, r_cpu = run_sequence_scan(cpu, init(cpu), cpu_inputs, noises=noises)
    kf_g, kf_c = r_gpu.is_keyframe.cpu(), r_cpu.is_keyframe
    dp = (r_gpu.p_wc.cpu() - r_cpu.p_wc).abs().max().item()
    dm = (r_gpu.num_matches.cpu() - r_cpu.num_matches).abs().max().item()
    print(f"path {name}: card vs CPU plain twins over {n_ref} frames: keyframes equal "
          f"{bool(torch.equal(kf_g, kf_c))}, max |dp_wc| {dp:.3e} m, max |d matches| {dm}",
          flush=True)
    # The card's kernels and the CPU's plain twins round differently, which
    # can move a subpixel position or flip a near-tied match; a keyframe
    # decision or a centimetre of position cannot.
    if not torch.equal(kf_g, kf_c) or dp > 1e-2 or dm > 5:
        _fail(f"{name}: the card's run disagrees with the CPU plain twins")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA card")
    print(_nvidia_smi(), flush=True)
    import vislam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.ops import build
    from vislam_tpu_torch.utils.config import SystemConfig

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, tf32 cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        _fail("TF32 is enabled")

    t0 = time.perf_counter()
    for name, path in zip(build.SOURCES, build.build_all(build.SOURCES)):
        print(f"build: {path}", flush=True)
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=N_FRAMES + 1, n_landmarks=300,
                                                  seed=0))
    print(f"data: {N_FRAMES + 1} frames 480x752 in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rows = kernel_phase(seq, SystemConfig())
    # Each row's launches come from the run of the path that uses it (the
    # D = 128 match from the default path, D = 256 from the akaze path).
    row_path = {"response_nms:shi_tomasi": "default", "response_nms:harris": "harris",
                "response_nms:dog": "dog", "response_nms:hessian": "kaze",
                "response_nms:fast": "akaze", "response_nms:_gradmag2": "kaze",
                "fed_evolve": "kaze", "match_top2:d128": "default",
                "match_top2:d256": "akaze"}
    launches = {name: path_phase(name, seq) for name in PATHS}
    for row in rows:
        row["launches"] = launches[row_path[row["name"]]][row["counter"]]

    print(_nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms")} for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

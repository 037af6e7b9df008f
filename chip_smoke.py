"""Smoke test of vislam_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc, the TF32 flags;
  1. build: both CUDA kernels from vislam_tpu_torch/ops/csrc/ with nvcc;
  2. kernels: each kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it, with the tests' tolerances; both timed
     with CUDA events (plain, kernel, kernel, plain);
  3. slice: run_sequence_scan of the default SystemConfig() (K = 768) over a
     60-frame 480x752 synthetic sequence with GT scale, with the launch
     counters reset just before and read just after; checks finite poses,
     ATE < 0.5 m, > 5 keyframes, > 90% of frames solved, every kernel
     launched at least twice per frame; prints frames/s, the host syncs
     left inside a step, and where a frame's time goes (wall time per
     stage, device busy share and kernels by device time from
     torch.profiler); then the first frames again on the CPU (plain twins,
     same random draws) as the reference the card's run must agree with.

The last two lines are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


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


def kernel_phase(seq, cfg_default):
    """Each kernel against its plain twin at main-path shapes and data."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.pyramid import build_pyramid
    from vislam_tpu_torch.ops.harris_kernel import shi_tomasi_nms, shi_tomasi_nms_plain
    from vislam_tpu_torch.ops.match_kernel import match_top2, match_top2_plain
    from vislam_tpu_torch.utils.config import FrontendConfig

    dev = torch.device("cuda")
    rows = []

    # Kernel 1 on the two pyramid levels of a frame, as the detector gives
    # them: the bf16 levels, widened to float32.
    img = torch.as_tensor(seq["images"][1]).to(dev, torch.float32)
    levels = [lv.float().contiguous() for lv in build_pyramid(img.to(torch.bfloat16), 2)]
    err1 = 0.0
    t_k1 = t_p1 = 0.0
    for lv in levels:
        k_nms, k_resp = shi_tomasi_nms(lv)
        p_nms, p_resp = shi_tomasi_nms_plain(lv[None])
        p_nms, p_resp = p_nms[0], p_resp[0]
        torch.cuda.synchronize()
        if not torch.allclose(k_resp, p_resp, rtol=5e-3, atol=5e-2):
            _fail(f"shi_tomasi_nms response disagrees at {tuple(lv.shape)}: max abs err "
                  f"{(k_resp - p_resp).abs().max().item()}")
        agree = (torch.isneginf(k_nms) == torch.isneginf(p_nms)).float().mean().item()
        if agree <= 0.995:
            _fail(f"shi_tomasi_nms NMS agreement {agree} <= 0.995 at {tuple(lv.shape)}")
        err = (k_resp - p_resp).abs().max().item()
        err1 = max(err1, err)
        tk, tp = _turns(lambda: shi_tomasi_nms_plain(lv[None]), lambda: shi_tomasi_nms(lv))
        t_k1 += tk
        t_p1 += tp
        print(f"kernel shi_tomasi_nms {tuple(lv.shape)}: max_abs_err {err:.3e} "
              f"(|resp| max {p_resp.abs().max().item():.1f}), nms agreement {agree:.6f}, "
              f"kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us", flush=True)
    rows.append(dict(name="shi_tomasi_nms", route="cuda",
                     source="vislam_tpu_torch/ops/csrc/shi_tomasi_nms.cu",
                     replaces="vislam_tpu/ops/harris_kernel.py:193",
                     max_abs_err=err1, ms=t_k1, plain_ms=t_p1))

    # Kernel 2 on real descriptors of two frames: K = 768 (default, two
    # levels) and K = 512 (one level), ungated and gated at the rescue's
    # 60 px disc.
    err2 = 0.0
    t_k2 = t_p2 = None
    for levels_used in (2, 1):
        fcfg = FrontendConfig(levels_used=levels_used)
        fa = extract_features(torch.as_tensor(seq["images"][0]).to(dev, torch.float32), fcfg)
        fb = extract_features(img, fcfg)
        K = fa.uv.shape[0]
        for gated in (False, True):
            gate = dict(uv_pred=fa.uv.contiguous(), uv_b=fb.uv.contiguous(),
                        gate_radius=cfg_default.frontend.guided_fallback_px) if gated else {}
            args = (fa.desc.contiguous(), fa.mask.contiguous(), fb.desc.contiguous(),
                    fb.mask.contiguous())
            k = match_top2(*args, **gate)
            p = match_top2_plain(*args, **gate)
            torch.cuda.synchronize()
            for name, a, b in (("min1", k[0], p[0]), ("min2", k[1], p[1])):
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                    _fail(f"match_top2 {name} disagrees (K={K}, gated={gated}): "
                          f"max abs err {(a - b).abs().max().item()}")
            err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
            err2 = max(err2, err)
            # Indices: exact away from near-ties (best and second best within
            # 1e-5 relative may legitimately swap).
            has = p[0] < 5e8
            untied = has & ((p[1] - p[0]).abs() > 1e-5 * p[0].clamp(min=1e-6))
            arg_ok = (k[2] == p[2])[untied].float().mean().item()
            col_ok = (k[3] == p[3])[fb.mask].float().mean().item()
            if arg_ok < 1.0 or col_ok < 0.99:
                _fail(f"match_top2 indices disagree (K={K}, gated={gated}): arg1 {arg_ok}, "
                      f"colarg {col_ok}")
            tk, tp = _turns(lambda: match_top2_plain(*args, **gate),
                            lambda: match_top2(*args, **gate))
            if K == 768:
                t_k2 = tk if t_k2 is None else t_k2 + tk
                t_p2 = tp if t_p2 is None else t_p2 + tp
            print(f"kernel match_top2 K={K} D=128 gated={gated}: max_abs_err {err:.3e}, "
                  f"arg1 exact {arg_ok:.4f} of {int(untied.sum())} untied rows, colarg "
                  f"{col_ok:.4f}, kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us",
                  flush=True)
    rows.append(dict(name="match_top2", route="cuda",
                     source="vislam_tpu_torch/ops/csrc/match_top2.cu",
                     replaces="vislam_tpu/ops/match_kernel.py:126",
                     max_abs_err=err2, ms=t_k2, plain_ms=t_p2))
    return rows


def profile_slice(eng, state, inputs):
    """Where a frame's time goes: wall time per stage (each stage alone,
    synchronised), then a torch.profiler pass over 10 frames for the device
    busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from vislam_tpu_torch.engine import run_sequence_scan
    from vislam_tpu_torch.engine.engine import frame_generator
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors
    from vislam_tpu_torch.frontend.pose import gumbel_noise, ransac_translation
    from vislam_tpu_torch.inertial.filters import madgwick_scan
    from vislam_tpu_torch.inertial.preintegration import preintegrate

    fe = eng.cfg.frontend
    img, imu, dt = inputs.images[5], inputs.imu[5], inputs.imu_dt[5]
    kf = state.kf_feat
    feat = extract_features(img, fe, eng.geom)
    rays = torch.nn.functional.normalize(torch.randn(kf.uv.shape[0], 3, device="cuda"), dim=-1)
    noise = gumbel_noise(frame_generator(0, 0, "cuda"), eng.cfg.backend.ransac_hyps,
                         kf.uv.shape[0], "cuda")
    R = torch.eye(3, device="cuda")

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
        "extract_features (2 levels, K=768)": lambda: extract_features(img, fe, eng.geom),
        "match_descriptors (ungated)": lambda: match_descriptors(
            kf.desc, kf.mask, feat.desc, feat.mask),
        "ransac_translation (512 x 768)": lambda: ransac_translation(
            rays, rays.roll(1, 0), R, kf.mask, uv_i=kf.uv, dispersion_pow=1.25, noise=noise),
        "whole step": lambda: eng.step(state, img, imu, dt, 0.1),
    }
    lines = [f"{name}: {wall_ms(fn):.2f} ms wall" for name, fn in stages.items()]

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
    print("profile: " + "\nprofile: ".join(lines), flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)


def slice_phase(seq, cfg):
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.engine.engine import frame_generator
    from vislam_tpu_torch.eval import ate_rmse
    from vislam_tpu_torch.frontend.pose import gumbel_noise
    from vislam_tpu_torch.ops.harris_kernel import shi_tomasi_nms
    from vislam_tpu_torch.ops.match_kernel import match_top2

    eng = VIOEngine(seq["calib"], cfg, device="cuda")

    def init(e):
        return e.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                            v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

    inputs = make_sequence_inputs(seq, 1, device="cuda")
    N = inputs.images.shape[0]
    # Warm-up on a short prefix (first-use library loads, allocator growth).
    run_sequence_scan(eng, init(eng), inputs._replace(
        images=inputs.images[:3], imu=inputs.imu[:3], imu_dt=inputs.imu_dt[:3],
        gt_pos=inputs.gt_pos[:3]))
    state0 = init(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    shi_tomasi_nms.launches = 0
    match_top2.launches = 0
    t0 = time.perf_counter()
    state, res = run_sequence_scan(eng, state0, inputs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"shi_tomasi_nms": shi_tomasi_nms.launches, "match_top2": match_top2.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # Two more timed runs of the same slice: the spread of frames/s on this
    # host (the step is bound by the host's dispatch of small launches).
    fps = [N / elapsed]
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
        _fail(f"non-finite or misshapen poses {p.shape}")
    poses = np.concatenate([seq["gt_pos"][:1], p])
    ate = ate_rmse(poses, seq["gt_pos"][: N + 1], align=False)
    solved = float(((ni >= 8) & (nm > 50)).mean())
    print(f"slice: {N} frames in {elapsed:.3f} s = {N / elapsed:.2f} frames/s "
          f"(default SystemConfig, K=768, 480x752, GT scale); ATE {ate:.4f} m; "
          f"keyframes {int(kf.sum())}; solved {solved:.3f}; rescues "
          f"{int(res.used_fallback.sum())}; peak device memory {peak_mb:.1f} MiB; "
          f"launches {launches}", flush=True)
    print(f"slice: frames/s over 3 runs {[round(f, 2) for f in fps]}, median "
          f"{float(np.median(fps)):.2f}", flush=True)
    if not ate < 0.5:
        _fail(f"ATE {ate} >= 0.5 m")
    if not kf.sum() > 5:
        _fail(f"only {int(kf.sum())} keyframes")
    if not solved > 0.9:
        _fail(f"only {solved:.3f} of frames solved")
    for name, n in launches.items():
        if n < 2 * N:
            _fail(f"{name} launched {n} times over {N} frames (< 2 per frame)")

    # Host syncs inside the step: one more frame under CUDA sync debug mode,
    # each synchronizing call located by the port's innermost frame on the
    # Python stack at the moment it warns.
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
    print(f"slice: host syncs inside one step: {len(syncs)} {sorted(set(syncs))}", flush=True)

    profile_slice(eng, state, inputs)

    # Reference on a small input: the first frames again on the CPU (the
    # plain twins), with the same random draws on both devices.
    n_ref = 10
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
                                 noises=[(a.cuda(), b.cuda()) for a, b in noises])
    cpu_inputs = sub._replace(**{k: getattr(sub, k).cpu()
                                 for k in ("images", "imu", "imu_dt", "gt_pos")})
    _, r_cpu = run_sequence_scan(cpu, init(cpu), cpu_inputs, noises=noises)
    kf_g, kf_c = r_gpu.is_keyframe.cpu(), r_cpu.is_keyframe
    dp = (r_gpu.p_wc.cpu() - r_cpu.p_wc).abs().max().item()
    dm = (r_gpu.num_matches.cpu() - r_cpu.num_matches).abs().max().item()
    print(f"slice: card vs CPU plain twins over {n_ref} frames: keyframes equal "
          f"{bool(torch.equal(kf_g, kf_c))}, max |dp_wc| {dp:.3e} m, max |d matches| {dm}",
          flush=True)
    # The card's kernels and the CPU's plain twins round differently, which
    # can move a subpixel position or flip a near-tied match; a keyframe
    # decision or a centimetre of position cannot.
    if not torch.equal(kf_g, kf_c) or dp > 1e-2 or dm > 5:
        _fail("the card's slice disagrees with the CPU plain twins")
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
    for name in ("shi_tomasi_nms", "match_top2"):
        print(f"build: {build.library_path(name)}", flush=True)
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=61, n_landmarks=300, seed=0))
    print(f"data: 61 frames 480x752 in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = SystemConfig()

    rows = kernel_phase(seq, cfg)
    launches = slice_phase(seq, cfg)
    for row in rows:
        row["launches"] = launches[row["name"]]

    print(_nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                             "max_abs_err", "ms", "plain_ms")} for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

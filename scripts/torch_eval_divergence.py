"""Where two runs of one EVAL config part, frame by frame: the port's card
run against its CPU run, and its online-BA run against its plain run.

    python3 scripts/torch_eval_divergence.py [--config 3|2|4] [--seeds 5]
                                             [--row plain|marg|open|photometric]
                                             [--max-frames N] [--cpu] [--out FILE]

Runs EVAL config 3's (or `--config 2`'s, or `--config 4`'s) pinned sequence
(`scripts/torch_eval_configs.py`) at GT scale (`--row plain`: the plain row
and the online BA), at IMU scale with the VI-BA under the `marg` gauge
(`--row marg`: row 3b `marg`, its steps without the refine as the "plain"
run), at IMU scale open loop (`--row open`: config 2's open loop, 3b's
on config 3, with the window VI-BA under the `ends` gauge as the online-BA
run: config 2's VI-BA row), or at GT scale with the photometric refine in
the step as the second run in place of the online BA (`--row photometric`:
row 3 photometric), every run stepped in lockstep, for each RANSAC seed:

1. The draws. Every run draws frame n's RANSAC hypotheses under the
   reference's key fold_in(PRNGKey(seed), n) (`engine.frame_key`), on the
   card by the draw kernel and on the CPU by its twin: the line says
   whether frame 1's draws of the two devices (the categorical kernel's
   and its twin's indices, under uniform logits) are equal.
2. Card against CPU, the plain step. Per frame: the keypoints each device
   detects on the frame's image (`extract_features`; the count, and how
   many keypoints of either set have none of the other within 0.01 px),
   the matches, the RANSAC inliers, the rescue taken, the keyframe flag
   and the positions apart; and the card's step from the CPU run's state
   on the same inputs and key, against the CPU's step: what the card's
   arithmetic alone changes in that frame.
3. Plain against online BA (`refine_window` on each keyframe: the `ends`
   gauge, which config 3 holds neutral; `--row marg`: the VI-BA under the
   `marg` gauge; `--row open`: the VI-BA), on the card (as the harness runs
   it) and on the CPU. Per frame the same fields, and at each keyframe how
   far the refine moved the live position and the keyframe anchor, and
   how far the card's refine of the CPU run's stepped state lands from
   the CPU's refine. `--row photometric` has the photometric step in
   place of the online BA, and per frame the card's photometric step from
   the CPU photometric run's state against the CPU's step.

For each pair, prints the first frame where the positions part by more
than 1e-6 m and the first frame where a decision differs (stages in the
step's order: detection, matches, inliers, rescue, keyframe), then each
run's ATE. With `--config 4` (row 4: the plain step, each keyframe
archived, then `correct_trajectory`), also the plain runs' archives: the
first keyframe where the card's and the CPU's differ, and the loops that
each archive closes on each device, which says whether a loop parts in
the archive or in the correction. --cpu puts the "card" runs on the CPU
(a check of the script off the card). Imports no JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_eval_configs import SEQUENCES, _imu  # noqa: E402

STAGES = ("detected", "matches", "inliers", "fallback", "keyframe")
APART_M = 1e-6


# The rows it follows: (SystemConfig sections replaced in the plain runs,
# in the second runs, at GT scale, whether the second runs refine the
# window on each keyframe: the online BA).
_MARG = dict(backend=dict(online_gauge="marg", vi_factors=True))
ROWS = {"plain": ({}, {}, True, True),
        "marg": (_MARG, _MARG, False, True),
        "open": ({}, dict(backend=dict(vi_factors=True)), False, True),
        "photometric": ({}, dict(engine=dict(photometric_refine=True)), True, False)}


class Run:
    """One run of the step over the sequence: its engine (keys from `seed`),
    state and per-frame records."""

    def __init__(self, name, seq, cfg, device, seed, online_ba, gt_scale=True, archive=False):
        from vislam_tpu_torch.engine import VIOEngine

        self.name, self.seq, self.seed = name, seq, seed
        self.online_ba, self.gt_scale = online_ba, gt_scale
        self.archive = [] if archive else None
        self.eng = VIOEngine(seq["calib"], cfg, seed, device=device)
        self.state = self.eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                                         v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
        self.last_kf = 0
        self.records = []

    def inputs(self, j):
        imu, dt = _imu(self.seq, j)
        gt = (float(np.linalg.norm(self.seq["gt_pos"][j] - self.seq["gt_pos"][self.last_kf]))
              if self.gt_scale else -1.0)
        return self.seq["images"][j], imu, dt, gt

    def advance(self, j):
        from vislam_tpu_torch.backend.trajectory_opt import record_from_feat
        from vislam_tpu_torch.engine.refine import refine_window

        c = self.seq["calib"]
        before = self.state
        inputs = self.inputs(j)
        self.state, res = self.eng.step(before, *inputs)
        rec = record(res)
        if rec["keyframe"]:
            self.last_kf = j
            if self.archive is not None:
                self.archive.append(record_from_feat(j, self.state.kf_R_wc, self.state.kf_p_wc,
                                                     self.state.kf_feat))
            if self.online_ba:
                stepped = self.stepped = self.state
                self.state = refine_window(stepped, self.eng.cfg, c.fx, c.fy, c.cx, c.cy)
                rec["refine_dp"] = _max_abs(self.state.p_wc, stepped.p_wc)
                rec["refine_dR"] = _max_abs(self.state.kf_R_wc, stepped.kf_R_wc)
        rec["p"] = self.state.p_wc.cpu().double().numpy()
        self.records.append(rec)
        return before, inputs


def _max_abs(a, b) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def record(res) -> dict:
    return {"keyframe": bool(res.is_keyframe), "matches": int(res.num_matches),
            "inliers": int(res.num_inliers), "fallback": bool(res.used_fallback),
            "p_step": res.p_wc.cpu().double().numpy()}


def detected(eng, image) -> tuple:
    """(count, uv (K, 2) float64 on the host) of the keypoints `eng`
    detects on `image`."""
    import torch

    from vislam_tpu_torch.frontend.features import extract_features

    img = torch.as_tensor(image).to(eng.device, torch.float32)
    f = extract_features(img, eng.cfg.frontend, eng.geom)
    uv = f.uv[f.mask].cpu().double()
    return int(uv.shape[0]), uv


def keypoints_apart(a, b, tol=0.01) -> tuple:
    """(keypoints of either set with none of the other within tol px,
    largest shift of the others)."""
    import torch

    if a.shape[0] == 0 or b.shape[0] == 0:
        return int(a.shape[0] + b.shape[0]), 0.0
    d = torch.cdist(a, b)
    da, db = d.min(1).values, d.min(0).values
    shared = da[da <= tol]
    return (int((da > tol).sum() + (db > tol).sum()),
            float(shared.max()) if shared.numel() else 0.0)


def parted(ra, rb) -> dict:
    """The first frame (1-based) where the two runs' positions part by more
    than APART_M, and the first where a decision differs, with the stages
    that differ there."""
    first_p = next((j + 1 for j, (a, b) in enumerate(zip(ra, rb))
                    if np.abs(a["p"] - b["p"]).max() > APART_M), None)
    first_d, stages = None, []
    for j, (a, b) in enumerate(zip(ra, rb)):
        stages = [s for s in STAGES if s in a and s in b and a[s] != b[s]]
        if stages:
            first_d = j + 1
            break
    dmax = max(float(np.abs(a["p"] - b["p"]).max()) for a, b in zip(ra, rb))
    return {"first_position_apart": first_p, "first_decision_apart": first_d,
            "stages": stages, "max_dp": dmax}


def archive_loops(seq, runs, device, log) -> dict:
    """Row 4's archives of the card's and the CPU's plain runs: the first
    keyframe where they differ, then `correct_trajectory` of each archive
    on each device (the reference harness's settings), its loops and the
    keyframes' largest error before and after."""
    from torch_eval_configs import _correct

    card, cpu = runs["card_plain"].archive, runs["cpu_plain"].archive
    first = None
    for i, (a, b) in enumerate(zip(card, cpu)):
        dp = float(np.abs(a.p_wc - b.p_wc).max())
        dR = float(np.abs(a.R_wc - b.R_wc).max())
        same_kp = np.array_equal(a.kp_mask, b.kp_mask)
        duv = float(np.abs(a.uv - b.uv)[a.kp_mask & b.kp_mask].max(initial=0.0))
        if a.frame_index != b.frame_index or dp > APART_M or not same_kp or duv > 0.01:
            first = {"keyframe": i, "frame": (a.frame_index, b.frame_index), "dp": dp,
                     "dR": dR, "kp_mask_equal": same_kp, "duv": duv}
            break
    log(f"archives: card {len(card)} keyframes, CPU {len(cpu)}; first keyframe apart "
        f"(frame index, |dp| > {APART_M:.0e} m, keypoint set, |duv| > 0.01 px): "
        + ("none" if first is None else
           f"#{first['keyframe']} at frames {first['frame']}: |dp| {first['dp']:.3e} m, |dR| "
           f"{first['dR']:.3e}, keypoint sets equal {first['kp_mask_equal']}, |duv| "
           f"{first['duv']:.3e} px"))
    out = {"first_apart": first, "correct": {}}
    for label, archive in (("card archive", card), ("CPU archive", cpu)):
        for dev in dict.fromkeys((device.type, "cpu")):
            r = _correct(seq, archive, dev)
            key = f"{label} corrected on {dev}"
            if not r:
                log(f"{key}: not corrected ({len(archive)} keyframes, the harness's least "
                    f"is 11)")
                continue
            out["correct"][key] = {k: r[k] for k in ("loops", "kf_maxerr_before",
                                                     "kf_maxerr_after")}
            log(f"{key}: {len(r['loops'])} loops {r['loops']}; keyframe error "
                f"{r['kf_maxerr_before']:.6f} -> {r['kf_maxerr_after']:.6f} m")
    return out


def compare(seq, device, seed, n, log, row="plain", archive=False) -> dict:
    """The three comparisons at one seed of `row` (`ROWS`), and with
    `archive` row 4's archives and loops (`archive_loops`); returns what it
    printed."""
    import torch

    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.engine.engine import MAIN_PATHS, RESCUE_PATHS, FrameKey
    from vislam_tpu_torch.engine.refine import refine_window
    from vislam_tpu_torch.ops.threefry_kernel import draw_categorical
    from vislam_tpu_torch.engine.state import tree_to
    from vislam_tpu_torch.eval import ate_rmse
    from vislam_tpu_torch.utils import prng
    from torch_eval_configs import _with

    sections, ba_sections, gt_scale, refine = ROWS[row]
    second = "online BA" if refine else row
    cfg, ba_cfg = _with(**sections), _with(**ba_sections)
    H, M = cfg.backend.ransac_hyps, cfg.frontend.max_keypoints
    first = [draw_categorical(FrameKey(prng.key_tensor(prng.prng_key(seed), d),
                                       torch.zeros((), dtype=torch.int32, device=d)),
                              MAIN_PATHS + RESCUE_PATHS, torch.zeros(M, device=d), (H,)).cpu()
             for d in (device, "cpu")]
    log(f"seed {seed}: frame 1's draws (uniform logits) on {device.type} and on the CPU equal "
        f"index for index: {torch.equal(*first)}; first indices {first[0][0, :4].tolist()}")

    runs = {
        "card_plain": Run("card plain", seq, cfg, device, seed, False, gt_scale, archive),
        "cpu_plain": Run("CPU plain", seq, cfg, "cpu", seed, False, gt_scale, archive),
        "card_ba": Run(f"card {second}", seq, ba_cfg, device, seed, refine, gt_scale),
        "cpu_ba": Run(f"CPU {second}", seq, ba_cfg, "cpu", seed, refine, gt_scale),
    }
    forced = []
    card_eng = VIOEngine(seq["calib"], cfg, seed, device=device)
    card_second = None if refine else VIOEngine(seq["calib"], ba_cfg, seed, device=device)
    t0 = time.perf_counter()
    for j in range(1, n):
        taken = {key: r.advance(j) for key, r in runs.items()}
        # The card's step from the CPU run's state, on the CPU run's inputs
        # and frame key.
        cpu_before, inputs = taken["cpu_plain"]
        card_eng.set_step_counter(j - 1)
        _, res = card_eng.step(tree_to(cpu_before, card_eng.device), *inputs)
        f = record(res)
        c = runs["cpu_plain"].records[-1]
        f.update(dp_from_cpu_state=float(np.abs(f["p_step"] - c["p_step"]).max()),
                 stages=[s for s in STAGES[1:] if f[s] != c[s]])
        n_card, uv_card = detected(card_eng, seq["images"][j])
        n_cpu, uv_cpu = detected(runs["cpu_plain"].eng, seq["images"][j])
        apart, shift = keypoints_apart(uv_card, uv_cpu)
        f.update(detected=(n_card, n_cpu), keypoints_apart=apart, keypoint_shift=shift)
        runs["card_plain"].records[-1]["detected"] = (n_card, apart)
        runs["cpu_plain"].records[-1]["detected"] = (n_cpu, 0)
        if card_second is not None:
            # The second row's step (no refine) on the card from its CPU
            # run's state, on that run's inputs and frame key.
            cpu_before, inputs = taken["cpu_ba"]
            card_second.set_step_counter(j - 1)
            _, res = card_second.step(tree_to(cpu_before, card_eng.device), *inputs)
            c = runs["cpu_ba"].records[-1]
            f.update(second_dp_from_cpu_state=_max_abs(res.p_wc, torch.as_tensor(c["p_step"])),
                     second_stages=[s for s in STAGES[1:] if record(res)[s] != c[s]])
        elif runs["cpu_ba"].records[-1]["keyframe"]:
            # The card's refine of the CPU online-BA run's stepped state.
            ba = runs["cpu_ba"]
            refined = refine_window(tree_to(ba.stepped, card_eng.device), ba.eng.cfg,
                                    seq["calib"].fx, seq["calib"].fy, seq["calib"].cx,
                                    seq["calib"].cy)
            f.update(refine_dp_from_cpu_state=_max_abs(refined.p_wc, ba.state.p_wc),
                     refine_dkf_from_cpu_state=_max_abs(refined.kf_p_wc, ba.state.kf_p_wc))
        forced.append(f)
    log(f"seed {seed}: {len(runs)} runs of {n - 1} frames in lockstep, "
        f"{time.perf_counter() - t0:.1f} s")

    out = {"seed": seed, "pairs": {}, "ate": {}, "frames": []}
    for j, f in enumerate(forced, start=1):
        line = (f"  frame {j}: detected card/CPU {f['detected'][0]}/{f['detected'][1]}, "
                f"{f['keypoints_apart']} apart (shared within {f['keypoint_shift']:.1e} px); "
                f"card step from the CPU state: |dp| {f['dp_from_cpu_state']:.2e} m"
                + (f", differs in {f['stages']}" if f["stages"] else "")
                + (f"; card refine from the CPU online BA's state: |dp| "
                   f"{f['refine_dp_from_cpu_state']:.2e} m, keyframes' |dp| "
                   f"{f['refine_dkf_from_cpu_state']:.2e} m"
                   if "refine_dp_from_cpu_state" in f else "")
                + (f"; card {second} step from its CPU state: |dp| "
                   f"{f['second_dp_from_cpu_state']:.2e} m"
                   + (f", differs in {f['second_stages']}" if f["second_stages"] else "")
                   if "second_dp_from_cpu_state" in f else ""))
        if (f["keypoints_apart"] or f["stages"] or f["dp_from_cpu_state"] > APART_M
                or f.get("refine_dkf_from_cpu_state", 0.0) > APART_M
                or f.get("second_dp_from_cpu_state", 0.0) > APART_M
                or f.get("second_stages")):
            log(line)
        out["frames"].append({k: v for k, v in f.items() if k != "p_step"})
    pairs = {"card vs CPU, plain": ("card_plain", "cpu_plain"),
             f"{second} vs plain, card": ("card_ba", "card_plain"),
             f"{second} vs plain, CPU": ("cpu_ba", "cpu_plain"),
             f"card vs CPU, {second}": ("card_ba", "cpu_ba")}
    for label, (a, b) in pairs.items():
        ra, rb = runs[a].records, runs[b].records
        p = parted(ra, rb)
        j = p["first_decision_apart"]
        where = ""
        if j is not None:
            x, y = ra[j - 1], rb[j - 1]
            where = ", ".join(f"{s} {x[s]} / {y[s]}" for s in p["stages"])
        log(f"seed {seed}: {label}: positions part (> {APART_M:.0e} m) first at frame "
            f"{p['first_position_apart']}, a decision first at frame {j}"
            + (f" ({where})" if where else "") + f"; largest |dp| {p['max_dp']:.3e} m")
        out["pairs"][label] = p
    for key, r in runs.items():
        poses = np.stack([x["p"] for x in r.records])
        ate = float(ate_rmse(poses, seq["gt_pos"][1:n], align=False))
        out["ate"][key] = ate
        moves = [(j + 1, x["refine_dp"], x["refine_dR"]) for j, x in enumerate(r.records)
                 if "refine_dp" in x]
        moved = ""
        if moves:
            moved = (f"; the refine moved the live position by at most "
                      f"{max(m[1] for m in moves):.3e} m and the anchor's rotation by "
                      f"{max(m[2] for m in moves):.3e} over {len(moves)} keyframes")
            out.setdefault("refine_moves", {})[key] = moves
        log(f"seed {seed}: {r.name}: ATE {ate:.6f} m, "
            f"{sum(x['keyframe'] for x in r.records)} keyframes{moved}")
    if archive:
        out["archives"] = archive_loops(seq, runs, device, lambda m: log(f"seed {seed}: {m}"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="3", choices=["2", "3", "4"])
    ap.add_argument("--seeds", default="5", help="comma-separated RANSAC seeds")
    ap.add_argument("--row", default="plain", choices=sorted(ROWS))
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="the card's runs on the CPU too")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import subprocess

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
    kw = dict(SEQUENCES[args.config])
    if args.max_frames:
        kw["n_frames"] = min(kw["n_frames"], args.max_frames)
    seq = make_synthetic_sequence(SyntheticConfig(**kw))
    out = [compare(seq, device, int(s), kw["n_frames"], lambda m: print(m, flush=True),
                   args.row, archive=args.config == "4") for s in args.seeds.split(",")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=lambda x: np.asarray(x).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where two runs of one EVAL config part, frame by frame: the port's card
run against its CPU run, and its online-BA run against its plain run.

    python3 scripts/torch_eval_divergence.py [--seeds 5] [--row plain|marg]
                                             [--max-frames N] [--cpu] [--out FILE]

Runs EVAL config 3's pinned sequence (`scripts/torch_eval_configs.py`) at
GT scale (`--row plain`: the plain row and the online BA), or at IMU scale
with the VI-BA under the `marg` gauge (`--row marg`: row 3b `marg`, its
steps without the refine as the "plain" run), every run stepped in
lockstep, for each RANSAC seed:

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
   `marg` gauge), on the card (as the harness runs
   it) and on the CPU. Per frame the same fields, and at each keyframe how
   far the refine moved the live position and the keyframe anchor, and
   how far the card's refine of the CPU run's stepped state lands from
   the CPU's refine.

For each pair, prints the first frame where the positions part by more
than 1e-6 m and the first frame where a decision differs (stages in the
step's order: detection, matches, inliers, rescue, keyframe), then each
run's ATE. --cpu puts the "card" runs on the CPU (a check of the script
off the card). Imports no JAX and nothing of the JAX package.
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


# The rows it follows: (SystemConfig sections replaced, at GT scale).
ROWS = {"plain": ({}, True),
        "marg": (dict(backend=dict(online_gauge="marg", vi_factors=True)), False)}


class Run:
    """One run of the step over the sequence: its engine (keys from `seed`),
    state and per-frame records."""

    def __init__(self, name, seq, cfg, device, seed, online_ba, gt_scale=True):
        from vislam_tpu_torch.engine import VIOEngine

        self.name, self.seq, self.seed = name, seq, seed
        self.online_ba, self.gt_scale = online_ba, gt_scale
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
        from vislam_tpu_torch.engine.refine import refine_window

        c = self.seq["calib"]
        before = self.state
        inputs = self.inputs(j)
        self.state, res = self.eng.step(before, *inputs)
        rec = record(res)
        if rec["keyframe"]:
            self.last_kf = j
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


def compare(seq, device, seed, n, log, row="plain") -> dict:
    """The three comparisons at one seed of `row` (`ROWS`); returns what it
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

    sections, gt_scale = ROWS[row]
    cfg = _with(**sections)
    H, M = cfg.backend.ransac_hyps, cfg.frontend.max_keypoints
    first = [draw_categorical(FrameKey(prng.key_tensor(prng.prng_key(seed), d),
                                       torch.zeros((), dtype=torch.int32, device=d)),
                              MAIN_PATHS + RESCUE_PATHS, torch.zeros(M, device=d), (H,)).cpu()
             for d in (device, "cpu")]
    log(f"seed {seed}: frame 1's draws (uniform logits) on {device.type} and on the CPU equal "
        f"index for index: {torch.equal(*first)}; first indices {first[0][0, :4].tolist()}")

    runs = {
        "card_plain": Run("card plain", seq, cfg, device, seed, False, gt_scale),
        "cpu_plain": Run("CPU plain", seq, cfg, "cpu", seed, False, gt_scale),
        "card_ba": Run("card online BA", seq, cfg, device, seed, True, gt_scale),
        "cpu_ba": Run("CPU online BA", seq, cfg, "cpu", seed, True, gt_scale),
    }
    forced = []
    card_eng = VIOEngine(seq["calib"], cfg, seed, device=device)
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
        if runs["cpu_ba"].records[-1]["keyframe"]:
            # The card's refine of the CPU online-BA run's stepped state.
            ba = runs["cpu_ba"]
            refined = refine_window(tree_to(ba.stepped, card_eng.device), card_eng.cfg,
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
                   if "refine_dp_from_cpu_state" in f else ""))
        if (f["keypoints_apart"] or f["stages"] or f["dp_from_cpu_state"] > APART_M
                or f.get("refine_dkf_from_cpu_state", 0.0) > APART_M):
            log(line)
        out["frames"].append({k: v for k, v in f.items() if k != "p_step"})
    pairs = {"card vs CPU, plain": ("card_plain", "cpu_plain"),
             "online BA vs plain, card": ("card_ba", "card_plain"),
             "online BA vs plain, CPU": ("cpu_ba", "cpu_plain"),
             "card vs CPU, online BA": ("card_ba", "cpu_ba")}
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
        refine = ""
        if moves:
            refine = (f"; the refine moved the live position by at most "
                      f"{max(m[1] for m in moves):.3e} m and the anchor's rotation by "
                      f"{max(m[2] for m in moves):.3e} over {len(moves)} keyframes")
            out.setdefault("refine_moves", {})[key] = moves
        log(f"seed {seed}: {r.name}: ATE {ate:.6f} m, "
            f"{sum(x['keyframe'] for x in r.records)} keyframes{refine}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
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
    kw = dict(SEQUENCES["3"])
    if args.max_frames:
        kw["n_frames"] = min(kw["n_frames"], args.max_frames)
    seq = make_synthetic_sequence(SyntheticConfig(**kw))
    out = [compare(seq, device, int(s), kw["n_frames"], lambda m: print(m, flush=True),
                   args.row) for s in args.seeds.split(",")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=lambda x: np.asarray(x).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())

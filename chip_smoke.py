"""Smoke test of vislam_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  0. environment: the card (nvidia-smi name and power limit), torch, CUDA,
     nvcc, the TF32 flags;
  1. build: every CUDA kernel from vislam_tpu_torch/ops/csrc/, one nvcc per
     source, all started together; then ptxas's registers, spills and
     shared memory of every kernel instance;
  2. kernels: each kernel, and each response family, against its plain
     PyTorch twin on the card at the shapes its path gives it, with the
     tests' tolerances. Response and FED are also held on ragged shapes
     ((37, 53), (1, 752), (480, 1)) and a batch of two, every response
     family at each of its tile heights, FED on 1, 3, 5 and 12 steps and
     with a distinct k per field; the match kernel on ragged shapes,
     all-invalid rows and columns and gates with empty discs; the batched
     window-track match (the anchor, shared, against W window slots in one
     call) at W = 10, ragged W, K and N, all-invalid slots and W = 1;
     the radius-1 and -3 NMS on the kernel's raw response; each kernel as the
     batched step calls it, under torch.func.vmap (the custom op's rule
     folds the map into one call): response and FED over B = 8 frames
     (FED with a distinct k each) against the per-frame kernel calls and
     the twin, the match at B = 8 with an A per pair (a_group 1) ungated
     and gated, the window match of 8 sequences (a_group W = 10) and
     ragged pairs (B = 3, K = 700, N = 333, an all-invalid entry, empty
     discs), every entry against the twin; then the match's custom-op
     dispatch cost; then the kernels of the batched nonlinear paths as
     their step calls them, folded over B = 4 frames (one per sequence):
     FED's 4- and 8-step cycles with each frame's own k, _gradmag2 on the
     frames, hessian and fast on both nonlinear levels, and the BRIEF-256
     match (D = 256, a_group 1) ungated and gated, each against the
     per-frame kernel calls and the twin;
     then phase random: the draw kernel against its twin on the card and
     against the CPU's twin: threefry_categorical (the reference's
     jax.random.categorical, the RANSAC's draws) index for index at the
     default path's calls (one frame key's main and rescue draws, 2 x 512
     of M = 768 each, logits log(w + 1e-9) of a real match mask and of a
     real gated re-match's), batch_vision's essential draw (its 4 keys
     vmapped, 512 x 8 of its K, on its own match masks' logits; one
     launch) and vmapped over 8 keys with 8 logits rows (one launch);
  3. paths: run_sequence_scan over a 480x752 synthetic sequence, K = 768,
     from the true initial state, for each frontend the port runs (GT
     scale) and for the GT-free modes:
       default    SystemConfig() (Shi-Tomasi, SIFT), 40 frames
       kaze       nonlinear scale space + hessian, 40 frames
       akaze      nonlinear scale space + fast + BRIEF-256, 40 frames
       harris     harris detector, 6 frames
       dog        dog detector, 6 frames
       imu_scale  SystemConfig(), GT-free (IMU scale, the VI alignment),
                  open loop, 40 frames (vi_aligned by frame 30)
       slam       GT-free with the in-step window VI-BA (vi_factors +
                  refine_in_step: bench.py's slam configuration), 45 frames
                  (cut from 60 to make room for phase eval; its latch
                  comes at frame 38-39)
     (the long paths but slam cut from 60 frames to 40, the short paths and
     the CPU references from 10 to 6, to keep the whole run under three
     quarters of its 1200 s limit on a slow host)
     Each path resets every launch counter just before its run and reads
     them just after; it fails unless each of its kernels ran exactly the
     expected times per frame. Each checks finite poses, prints frames/s
     (the median of 3 timed runs; the slam path's one run) and the
     host syncs left inside a step (sync debug mode), and runs its
     first 6 frames again on the CPU (plain twins; both runs at seed 0,
     no draw shipped across: the draw kernel and its twin give the same
     bits) as the reference the card must agree with; the default path 20
     frames, keyframes equal and positions within 1e-5 m. default, kaze, imu_scale and
     slam also hold ATE < 0.5 m, > 5 keyframes and > 90% of frames solved,
     and the GT-free paths their latch by the last frame (imu_scale
     vi_aligned, slam vi_engaged); the akaze analog does not track on this
     sequence in the reference either, so it has no accuracy bound. Then
     one refine_window call on the slam path's final (engaged) state, on
     the card and on the CPU: refined poses within 1e-3 m, the window
     VI-BA's iterations equal.
     Then three batched paths (run_batch_scan: each frame one
     torch.func.vmap call of the step over B sequences, seeds 0 to B - 1):
       batch8      SystemConfig(), GT scale, 8 sequences x 20 frames
                   (cut from 60 to 40, then to 20, for the script's time)
       batch32     SystemConfig(), GT scale, 32 sequences x 6 frames (cut
                   from 24 to 16, then to 6, for the script's time)
       batch_slam  the slam path's configuration, GT-free, 4 x 4 frames
                   (cut from 60 to 30, then to 12 to make room for phase
                   eval, then to 10 for the two paths below, then to 4)
       batch_kaze  the kaze path's configuration (nonlinear + hessian),
                   GT scale, 4 x 6 frames (cut from 12)
       batch_akaze the akaze path's (nonlinear + fast + BRIEF-256), GT
                   scale, 4 x 6 frames (cut from 12)
     each printing aggregate frames/s (B x N frames over wall, 3 runs;
     batch_slam 1),
     exact launch counts per batched step (the nonlinear paths: 2 FED
     calls of 5 launches, 2 of the detector, 1 _gradmag2, 2 matches), 0
     host syncs per batched step, peak memory, each entry's ATE, and each
     entry's first 6 frames against its unbatched card run on the same
     keys (keyframes equal, positions within 1e-3 m); batch8 and
     batch_kaze hold every entry's ATE < 0.5 m (AKAZE does not track on
     these sequences, in the reference either);
     Then the port's CLI (`vislam_tpu_torch/cli.py`, phase cli), each
     check fatal:
       a. `main(["--synthetic", "21"])` in this process, 3 times: its rows
          equal run_sequence_scan on the same sequence
          (positions within 1e-5 m, keyframes equal), its launches per
          frame the default path's, ATE < 0.5 m, 0 host syncs inside one
          step_pipelined call; the host loop's frames/s (median of 3)
          printed beside run_sequence_scan's from this process, the mean
          drain time per burst (scripts/torch_host_loop.py resolves
          the loop's cost over the scan in interleaved rounds);
       b. a 21-frame EuRoC fixture with a 1 s static IMU prefix and radial
          distortion (the images warped on the card, the PNGs and the
          OpenCV XML written by the port): the host loop (ATE < 0.5 m, the
          prefetch thread's read ms per frame printed), one frame's remap
          on the card against the CPU's, and --scan's rows against the
          host loop's (within 1e-5 m, keyframes equal);
       c. --imu-scale (SLAM mode) on that fixture for 6 frames: finite
          poses, one window match per step;
       d. a 31-frame KITTI fixture (vision-only rotation): the CLI's run,
          then its first 10 frames staged and stepped on the card and, from
          the card's state each frame, on the CPU with the same key:
          keyframes equal; each frame's essential solve on the card equal
          to the CPU's on the card's own rays; positions within 1e-3 m
          where the devices' solves agree (a frame with two near-equal-
          support solutions may take the other one from the features'
          last-bit rounding: at most 3 of 10, counted); 0 host syncs
          inside one step_pipelined call;
       e. --checkpoint over 11 frames, --resume to 21: the rows of the
          uninterrupted run (within 1e-5 m, keyframes equal);
       f. `python -m vislam_tpu_torch.cli --synthetic 8` as a
          subprocess: exit 0 and an ATE line;
     Then the map backend (`vislam_tpu_torch/backend/`, phase map), each
     check fatal:
       a. EVAL config 4's inputs (seed 21, 86 frames, GT scale, its
          correct_trajectory settings): the scan, its keyframe archive
          (keyframes_from_scan: 2 shi_tomasi launches per keyframe), then
          correct_trajectory in SE(3) and Sim(3) on the card (2 match
          launches per candidate measured, as the host counts them): a
          loop spanning >= 10 keyframes, the keyframes' max error falls
          (printed beside the reference's 0.267 -> 0.146 m), and the CPU's
          correct_trajectory on the card's archive gives the same loops
          (inliers within 2) and positions within 1e-3 m;
       b. the CLI: --synthetic 86 without and with --loop-correct
          --save-map (frames/s printed, not bounded; the archive copy's ms
          per keyframe), the "loop closures:" and "map saved:"
          lines, the map read by numpy with the reference's keys and
          dtypes, then --load-map --reloc over 21 frames ("loaded map:");
       c. tests/test_reloc.py's outage (44 frames, vision blanked on 28-35,
          drift injected at 30): attempt_relocalization at frame 39 on the
          card succeeds and halves the error; on the CPU, with the same
          archive and live features, the same keyframe and the pose within
          1e-3 m; the host syncs of one attempt printed;
       d. SE(3) and Sim(3) pose graphs at EVAL config 6's size (315 nodes,
          two laps of a drifted chain, 8 loop edges), 15 iterations on the
          card and on the CPU: final costs within 1e-4 relative, positions
          within 1e-2 m (what the float32 cost resolves), rotations and
          scales within 1e-3, 0 host syncs inside, wall ms printed;
       e. Sim(3) exp's W in float32 on the card against float64 over
          theta, |sigma| in {0} u logspace(-8, 0) and rotations near pi:
          the largest error, and in 1e-6..1e-2, within 4e-7;
     Then the step options (phase variants), each check fatal, each path
     at 480x752, K = 768 (the KITTI mode: one level, K = 512), from the
     true initial state:
       oriented      oriented SIFT (frontend.oriented), GT scale, 30 frames
                     (cut from 60)
       gated         the always-on guided match, 30 px, GT scale, 30 (cut
                     from 60)
       photometric   the photometric refine on EVAL config 3's sequence
                     (seed 1, 350 landmarks, its amplitudes), GT scale, 59
       marg          SLAM mode with the marg gauge on config 3's sequence,
                     GT-free, 34 (EVAL row 3b's configuration, cut from its
                     59 frames: the VI-BA engages at frame 26, the prior is
                     in place from frame 28 and feeds the window solve on
                     the keyframes after it; a prior trace of 0 by the
                     last frame, or vi_engaged unset, fails)
       oldest2       the in-step vision-only window BA under the oldest2
                     gauge, GT scale, 12 (cut from 30)
       batch_vision  run_batch_scan with vision-only rotation, 4 x 20
     each with its exact launches per frame (every other counter 0; gated:
     one gated match and no other), frames/s of one run, 0 host syncs per
     step, its first 6 frames on the CPU at the same seed (keyframes
     equal, positions at the tier-1 tolerances; oldest2 each CPU step from
     the card's state before it), its ATE beside the reference's on the
     same run (scripts/variant_reference_ate.py) and EVAL config 3's
     regenerated rows, bounded at 0.5 m where the reference meets it;
     batch_vision each entry against its unbatched card run;
     Then the distributed paths (`vislam_tpu_torch/parallel/`, phase
     parallel), each check fatal, in a pool of 1 rank (NCCL) and one of 4
     ranks sharing the card (gloo), spawned once after the kernels are
     built:
       a. __graft_entry__.dryrun_multichip's problems (W = 10, L = 512 per
          rank): dist_bundle_adjust, dist_vi_bundle_adjust without and with
          the online bias, 4 LM iterations: on 1 NCCL rank equal to the
          one-process solve on the card within 1e-5 with 0 host syncs (sync
          debug mode); on 4 gloo ranks (L = 2048) against the one-process
          solve at tests/test_parallel.py's tolerances (R 1e-4, t 1e-3 (VI
          2e-3), X 5e-3, v 2e-3 (online bias 1e-2), bg 1e-3, ba 1e-2, final
          cost rtol 1e-3 + atol 1e-5); ms per LM iteration and the gloo
          ranks' host syncs printed;
       b. the CLI on EVAL config 2's sequence cut to 31 frames,
          `--synthetic 31 --imu-scale --vi-ba --dist-ba 4` (its own 4
          ranks): the mesh line, accepted, each rank's launches exactly one
          batched window match, the refined keyframe rows within 1e-2 m of a
          1-rank refine of the same window, the ATE printed;
       c. run_batch_sharded, batch8's configuration cut to 8 x 6 frames,
          4 ranks x 2 (each rank makes and stages its own sequences):
          exact launches per batched step in every rank, the gathered batch
          against run_batch_scan of the 8 in this process (keyframes equal,
          positions within 1e-3 m), the aggregate frames/s of both printed;
     Then the evaluation layer (`vislam_tpu_torch/eval/`, phase eval),
     each check fatal:
       a. `eval/matchability.py::repo_match_pairs` on 6-frame `natural` and
          `repetitive` adversarial sequences at 752x480 for three of
          scripts/eval_matchability.py's frontend rows (the default,
          dog+sift guided at 30 px, fast+BRIEF): exact launches (2 of the
          response per frame, 1 match per pair; the guided row's gated),
          the card's matches the CPU's (each within 1e-2 px of its twin;
          at most 1% of them without a twin), each row's inlier rate
          beside MATCHABILITY.md's, natural's above 0.9;
       b. `eval/runner.py::run_vio_sequence` over the default path's first
          20 frames at GT scale, on the card and on the CPU at one seed (the
          same draws): exact launches, poses within 1e-2 m, ATE < 0.5 m;
     Then the last of the JAX package's public surface (phase api), each
     check fatal: orientation_from_accel, complementary_scan and dead_reckon
     over the default path's whole IMU stream, card against CPU (the
     tests' float32 bounds at 200 samples, grown linearly with the
     stream's length); on the card, the static tilt (1e-5 rad), the
     complementary filter on tests/test_inertial.py's gentle sequence
     (0.05 rad) and dead_reckon and predict_state over three 0.5 s
     windows of the default path's stream against GT (0.01 m, 0.02 m/s);
     then frames 0 and 2 of the default path: their features and match
     (exact launches), gather_matched and epipolar_inlier_mask, card
     against CPU; on the GT direction over half of the matches inliers,
     and over 5x as many as on each direction perpendicular to it;
  4. stage times: for each long path (all but harris and dog), where a frame's wall time goes
     (each stage alone, synchronised; the GT-free paths add
     vi_align_window, slam refine_window);
  5. kernel times: each kernel of phase 2 at its path's shapes, kernel and
     twin as 100 back-to-back calls between CUDA events (plain, kernel,
     kernel, plain); then each call under torch.profiler, whose device
     launches must be as the source says; then the kernel as the replay
     of a CUDA graph that captured 100 calls (the device's time without
     the host's launch cost);
  6. report: one line per call with its times, its bound (the larger of the function's bytes over
     the HBM rate and its operations over the peak rate of their type:
     float32 on the CUDA cores, the match's a.b as 3xTF32 on the tensor
     cores, the window match's, whose operands are bfloat16 values, as
     one bfloat16 pass, the draw kernels' int32 operations on the CUDA
     cores) and the share of the graph time the bound is;
  7. traces: for each long path, torch.profiler over 1 frame (cut from 3
     to 2 when the batched nonlinear paths came, then to 1), and for each batched
     path but batch_slam over its first step (2 on batch8 and batch32 until
     then) and one
     step's main RANSAC draw alone (one launch), and one frame (batched step)
     of the variant paths photometric and batch_vision: the device busy
     share, launches per frame (per batched step) and the kernels by device
     time.
Each phase prints its own wall time ("phase ...: s"). vmap's per-example
fallback is disabled, so an operator without a batching rule fails the
run instead of looping over a batch.

Wall-clock timings come before graph capture and before any profiler
run in the process: a profiler run was seen to leave the host slower at
every later launch (the default path fell from ~16 to ~10 frames/s on an
H100 machine when profiling ran before it).

The last two lines are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}. In the table, ms, plain_ms, graph_ms and
bound_ms of a row are sums over the calls one frame makes (the two levels of
a response family; FED's 4- and 8-step cycles; the ungated and gated match
at K = 768; the window match's one batched call; the batched rows the
calls of one batched step at B = 8, the rows named batch_kaze and
batch_akaze at B = 4, the essential draw's row batch_vision's one call at
B = 4), launches_per_call lists
those calls' device launches, and
library_ms is null: no single PyTorch call computes any of the four
functions. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

DEV = "cuda"
N_FRAMES = 60      # frames of the sequence the paths, the CLI and phase variants step
# Frames of the long paths (the slam path: SLAM_FRAMES), cut from 60 to keep
# the whole run under three quarters of its 1200 s limit on a slow host.
LONG_FRAMES = 40
N_SHORT = 6        # frames of the short paths and of each CPU reference (cut
                   # from 10 with LONG_FRAMES)
# The default path's card-vs-CPU run: 20 frames at seed 0 on both devices,
# positions within 1e-5 m (4.4e-6 m was measured on shared draws before
# the devices drew one stream, PERF.md).
DEFAULT_CPU_FRAMES = 20
DEFAULT_CPU_ATOL = 1e-5
# The slam path, cut from 60 frames to make room for phase eval: its
# vi_engaged latch comes with its 21st keyframe (the promotion deadline,
# vi_two_phase_max_kfs), at frame 38 of this sequence, so the engaged window
# VI-BA runs on its last ~7 frames.
SLAM_FRAMES = 45
TILE_ROWS = (8, 16, 32)   # the response kernel's tile heights, each checked

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): HBM bytes/s, float32 flop/s outside the tensor cores, and TF32
# and bfloat16 flop/s on the tensor cores. A kernel's bound is the larger of its
# function's bytes (inputs read once, outputs written once) over the HBM
# rate and its operations, each type over its own rate, summed.
# The draw kernel's hash runs on the CUDA cores' int32 units: 132 SMs x 64
# lanes x 1.98 GHz (the Hopper white paper's INT32 units per SM at the data
# sheet's boost clock; the guide's table has no int32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int32": 16.7e12}
# Float32 operations per output pixel of each response family, counted from
# the function (vislam_tpu/ops/harris_kernel.py `_response_vmem` and the
# 5x5 NMS) evaluated as written: an add, subtract, multiply, divide, min,
# max, abs, sqrt or compare one each, an n-tap filter n multiplies and
# n - 1 adds (zero taps dropped), negations the formula only undoes not
# counted. Scharr 8 per direction (smooth 5, difference 3), a 7-tap (9-tap)
# separable blur 26 (34) per field, the NMS 25 (24 max, 1 compare):
#   shi_tomasi  16 + 3 products + 3 blurs 78 + eigenvalue 10 + NMS = 132
#   harris      16 + 3 + 78 + det - 0.04 tr^2 7 + NMS = 129
#   dog         blurs 26 + 34 + |difference| 2 + NMS = 87
#   hessian     blur 26 + Scharr 16, of gx 16, of gy (y only) 8 + det 3 + NMS = 94
#   fast        ring - centre 16 + bright 9-arc score 143 (16 x 8 min, 15 max)
#               + dark score 144 (the same with min and max swapped, one
#               negation) + max 1 + NMS = 329
#   _gradmag2   blur 26 + Scharr 16 + gx^2 + gy^2 3 = 45 (no NMS)
RESPONSE_FLOP_PER_PX = {"shi_tomasi": 132, "harris": 129, "dog": 87, "hessian": 94,
                        "fast": 329, "_gradmag2": 45}
# One FED step (vislam_tpu/ops/fed_kernel.py `_kernel`), the same rule: 5-tap
# blur 18, Scharr 16, conductivity 6, flux over 4 neighbours 19, update 2.
FED_FLOP_PER_PX_STEP = 61
# match_top2, per (row, column) pair besides a.b: the distance 4 (add,
# multiply, subtract, max), the row top-2 2 and the column minimum 1
# compares; gated, the disc test 6 more. a.b itself, 2 D per pair, runs at
# float32 accuracy on the tensor cores only as 3xTF32 (three TF32 products).
# The window match's operands are the bfloat16 bank's values (widened to
# float32 exactly), so its a.b needs one bfloat16 pass: 2 D per pair at the
# bfloat16 rate.
MATCH_FLOP_PER_PAIR = 7
GATE_FLOP_PER_PAIR = 6
# The draw kernels' int32 operations per value, counted from the function
# (utils/prng.py): the hash's 2 key adds, 20 rounds of add, rotate and xor,
# 5 injections of 2 adds, then the words' xor, the shift and the OR into
# the exponent: 75. Their bound is these against the bytes moved. The two
# logs (and the categorical's add and compare) are left out: the function
# needs two float32 logs (JAX's gumbel), a few operations a value on pipes
# that issue beside the int32 ones; the port's float64 logs are its
# choice, for bit-equal logs on both devices.
THREEFRY_INT32_OPS_PER_VALUE = 75


@dataclasses.dataclass(frozen=True)
class Path:
    """A path: its frontend and backend overrides, GT or IMU scale, frames,
    whether accuracy is checked, the launches per frame each kernel
    (counter name) must show, the state latch a GT-free run must have set
    by its last frame, and a note printed with it (a cut)."""

    per_frame: dict
    frames: int = LONG_FRAMES
    accuracy: bool = True
    frontend: dict = dataclasses.field(default_factory=dict)
    backend: dict = dataclasses.field(default_factory=dict)
    gt_scale: bool = True
    latch: str = ""
    runs: int = 3        # timed runs of a long path (frames/s: their median)
    note: str = ""       # printed with the path (a cut)


# Every path's frame draws its RANSAC hypotheses with the categorical draw
# kernel, one launch per solve: the main solve's and the rescue's (the
# always-gated and vision-only steps have no rescue: DRAW_ONE).
DRAW = {"threefry_categorical": 2}
DRAW_ONE = {"threefry_categorical": 1}
_LONG_CUT = ("cut in depth from 60 frames to 40 (its CPU reference from 10 to 6) to keep the "
             "run under three quarters of its 1200 s limit on a slow host")
_SHORT_CUT = ("cut in depth from 10 frames to 6 to keep the run under three quarters of its "
              "1200 s limit on a slow host")
PATHS = {
    "default": Path({"shi_tomasi": 2, "match_top2": 2, **DRAW}, note=_LONG_CUT),
    "kaze": Path({"fed_evolve": 2, "hessian": 2, "_gradmag2": 1, "match_top2": 2, **DRAW},
                 frontend=dict(scale_space="nonlinear", detector="hessian"), note=_LONG_CUT),
    "akaze": Path({"fed_evolve": 2, "fast": 2, "_gradmag2": 1, "match_top2": 2, **DRAW},
                  accuracy=False, frontend=dict(scale_space="nonlinear", detector="fast",
                                                descriptor="brief"), note=_LONG_CUT),
    "harris": Path({"harris": 2, "match_top2": 2, **DRAW}, N_SHORT, False,
                   frontend=dict(detector="harris"), note=_SHORT_CUT),
    "dog": Path({"dog": 2, "match_top2": 2, **DRAW}, N_SHORT, False,
                frontend=dict(detector="dog"), note=_SHORT_CUT),
    # Open loop, vi_engaged needs window excitation >= 1.5 m/s, which this
    # sequence does not reach (in the reference either): its latch is
    # vi_aligned. The slam path also engages by the promotion deadline.
    "imu_scale": Path({"shi_tomasi": 2, "match_top2": 2, **DRAW}, gt_scale=False,
                      latch="vi_aligned", note=_LONG_CUT + " (vi_aligned by frame 30)"),
    # Per frame: the per-frame and guided matches, then the window match
    # (the one batched call).
    # One timed run (~45 s on a slow host; three took 130 s).
    "slam": Path({"shi_tomasi": 2, "match_top2": 3, "match_top2_batched": 1, **DRAW},
                 SLAM_FRAMES,
                 gt_scale=False, latch="vi_engaged",
                 backend=dict(vi_factors=True, refine_in_step=True), runs=1,
                 note="cut in depth from 60 frames to 45 (its latch at frame 38; its CPU "
                      "reference from 10 frames to 6, to keep the run under three quarters "
                      "of its 1200 s limit on a slow host)"),
}
SLAM_PATH = "slam"
# Frames each long path's profiler trace covers: the trace's processing
# grows with the launches (the slam path makes ~23k a frame); it was most
# of the run's time at 10 frames (3 on the slam path), and at 5 (2) it kept
# the whole run, batched paths added, over half of its time limit; cut from
# 3 to 2 when the batched nonlinear paths came, then to 1 to keep the run
# under three quarters of its limit.
TRACE_FRAMES = {"default": 1, "kaze": 1, "akaze": 1, "imu_scale": 1, SLAM_PATH: 1}


@dataclasses.dataclass(frozen=True)
class BatchPath:
    """A batched path: B sequences (seeds 0 to B - 1) stepped together by
    run_batch_scan from their true initial states, its frames, GT or IMU
    scale, frontend and backend overrides, whether each entry's ATE is
    bounded, the launches per batched step each counter must show (every
    other counter 0), the steps its trace covers and a note printed with it
    (a cut)."""

    sequences: int
    frames: int
    per_step: dict
    frontend: dict = dataclasses.field(default_factory=dict)
    backend: dict = dataclasses.field(default_factory=dict)
    gt_scale: bool = True
    accuracy: bool = False
    trace_steps: int = 2     # 0: not traced
    runs: int = 3            # timed runs (aggregate frames/s: their median)
    note: str = ""


# Per batched step: one response launch per level, the two matches (main,
# gated rescue; A per pair) and the two draws (every sequence's keys folded
# into each launch) for the whole batch; SLAM mode adds the window match
# (an A per sequence shared by its W slots).
_BATCH_STEP = {"shi_tomasi": 2, "match_top2": 2, "match_top2_per_pair": 2,
               "match_top2_gated": 1, **DRAW}
NONLINEAR_B = 4     # sequences of batch_kaze and batch_akaze
_NONLINEAR_STEP = {"fed_evolve": 2, "_gradmag2": 1, "match_top2": 2, "match_top2_per_pair": 2,
                   "match_top2_gated": 1, **DRAW}
BATCH_PATHS = {
    "batch8": BatchPath(8, 20, _BATCH_STEP, accuracy=True, trace_steps=1,
                        note="cut in depth from 60 frames to 40: the script's "
                             "time, the host varying ~30% between calls; traced over 1 "
                             "step (was 2) to make room for batch_kaze and batch_akaze; "
                             "then to 20 (batch_vision steps these sequences' first 20 "
                             "frames) to keep the run under three quarters of its limit"),
    "batch32": BatchPath(32, 6, _BATCH_STEP, trace_steps=1,
                         note="cut in depth from 24 frames to 16 to pay for phase random "
                              "and the default path's 20-frame CPU run; traced over 1 step "
                              "(was 2) to make room for batch_kaze and batch_akaze; then to "
                              "6 to keep the run under three quarters of its limit"),
    "batch_slam": BatchPath(4, 4, {**_BATCH_STEP, "match_top2": 3, "match_top2_batched": 1},
                            backend=dict(vi_factors=True, refine_in_step=True), gt_scale=False,
                            trace_steps=0, runs=1,
                            note="cut in depth from 60 frames to 30, then to 12 to make "
                                 "room for phase eval, then to 10 (the frames each entry "
                                 "is held against its unbatched run) for batch_kaze and "
                                 "batch_akaze: at 60 its three timed runs took the whole "
                                 "script past half of its 1200 s limit; vi_engaged (the "
                                 "promotion deadline, ~frame 35) is printed, not required; "
                                 "then timed once and not traced (77 s and 54 s on a slow "
                                 "host) to pay for the categorical draw kernel's rows; then "
                                 "to 4 (35 s on a fast host at 10, most of it the entries' "
                                 "unbatched runs) to keep the run under three quarters of "
                                 "its limit"),
    # The nonlinear frontends batched: per step the folded FED's two cycles
    # (5 launches), the detector and the contrast statistic (_gradmag2)
    # folded, and the two matches (AKAZE's at D = 256, a_group 1).
    "batch_kaze": BatchPath(NONLINEAR_B, 6, {**_NONLINEAR_STEP, "hessian": 2},
                            frontend=dict(scale_space="nonlinear", detector="hessian"),
                            accuracy=True, trace_steps=1,
                            note="cut in depth from 12 frames to 6 to keep the run under "
                                 "three quarters of its limit"),
    "batch_akaze": BatchPath(NONLINEAR_B, 6, {**_NONLINEAR_STEP, "fast": 2},
                             frontend=dict(scale_space="nonlinear", detector="fast",
                                           descriptor="brief"), trace_steps=1,
                             note="AKAZE does not track on these sequences (in the reference "
                                  "either): its ATE is printed, not bounded; cut in depth "
                                  "from 12 frames to 6 to keep the run under three quarters "
                                  "of its limit"),
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
    kernel, plain within one process on one card; a plain version slower
    than 1 ms a call is timed over ~100 ms of calls (at least 5), not 100
    calls."""
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    n = max(5, min(100, int(0.1 / max(time.perf_counter() - t0, 1e-6))))
    p1 = _time_ms(plain, n, min(n, 10))
    k1 = _time_ms(kernel)
    k2 = _time_ms(kernel)
    p2 = _time_ms(plain, n, min(n, 10))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Mean time of one call replayed from a CUDA graph that captured
    `calls` calls: the device's time per call without the host's cost
    between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _launches_per_call(fn, expected: int, sessions: int = 5) -> int:
    """Device launches (kernels and memsets) of one call, from torch.profiler:
    the most that any of up to `sessions` sessions recorded, stopping once
    one reaches `expected`. Now and then a short session records no device
    event at all (PERF.md, chip runs 8 and 12); none records a launch that
    did not happen, so a kernel launching too often or too rarely still
    fails."""
    from torch.profiler import ProfilerActivity, profile

    best = 0
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(1 for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA))
        if best >= expected:
            break
    return best


def _measure(label, plain, kernel, nbytes, work, launches) -> dict:
    """One call to time in phase 5: its bound from the function's bytes and
    its operations (`work`: (count, type in PEAK_FLOP_PER_S, how counted)
    terms), and the device launches it must make."""
    flop_text = " + ".join(f"{text} = {n / 1e6:.1f} MFLOP {kind} / "
                           f"{PEAK_FLOP_PER_S[kind] / 1e12:g} TFLOP/s"
                           for n, kind, text in work)
    return dict(label=label, plain=plain, kernel=kernel, nbytes=nbytes, flop_text=flop_text,
                expected=launches, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=sum(n / PEAK_FLOP_PER_S[kind] for n, kind, _ in work) * 1e3)


def _row(name, counter, source, replaces, max_abs_err, measures, extra=()) -> dict:
    """A kernel table row over the calls one frame makes (`extra`: other
    shapes, timed and printed only), timed in phases 5 and 6."""
    return dict(name=name, counter=counter, route="cuda", source=source, replaces=replaces,
                max_abs_err=max_abs_err, library_ms=None, measures=measures, extra=list(extra))


def _calls(rows) -> list:
    return [m for row in rows for m in row["measures"] + row["extra"]]


def timing_phase(rows) -> None:
    """Every call back-to-back in turns with its twin; then its device
    launches under torch.profiler (fails unless as expected); then every
    call replayed from a CUDA graph. The profiler runs after the wall-clock
    times and before any graph capture (PERF.md, chip runs 7-8 and 12)."""
    for m in _calls(rows):
        m["ms"], m["plain_ms"] = _turns(m["plain"], m["kernel"])
    for m in _calls(rows):
        m["launches"] = _launches_per_call(m["kernel"], m["expected"])
        if m["launches"] != m["expected"]:
            _fail(f"{m['label']}: {m['launches']} device launches per call, expected "
                  f"{m['expected']}")
        if m.get("count_plain"):
            m["plain_launches"] = _launches_per_call(m["plain"], 10 ** 9, sessions=2)
    for m in _calls(rows):
        m["graph_ms"] = _graph_ms(m["kernel"])


def report_phase(rows) -> None:
    """Every call's line, and one frame's calls summed into each row."""
    for m in _calls(rows):
        n = m["launches"]
        bound = max(m["bytes_ms"], m["ops_ms"])
        twin = (f" (the plain twin: {m['plain_launches']})" if "plain_launches" in m else "")
        print(f"kernel {m['label']}: back-to-back {m['ms'] * 1e3:.2f} us, graph "
              f"{m['graph_ms'] * 1e3:.2f} us, plain {m['plain_ms'] * 1e3:.1f} us; {n} launches "
              f"per call{twin}; bound {bound * 1e3:.3f} us = max({m['nbytes'] / 1e6:.3f} MB / 3.35 TB/s, "
              f"{m['flop_text']}), "
              f"{'bytes' if m['bytes_ms'] >= m['ops_ms'] else 'operations'}; "
              f"{bound / m['graph_ms']:.1%} of the graph time", flush=True)
    for row in rows:
        ms = row.pop("measures")
        row.pop("extra")
        bytes_ms = sum(m["bytes_ms"] for m in ms)
        ops_ms = sum(m["ops_ms"] for m in ms)
        row.update(ms=sum(m["ms"] for m in ms), plain_ms=sum(m["plain_ms"] for m in ms),
                   graph_ms=sum(m["graph_ms"] for m in ms),
                   bound_ms=sum(max(m["bytes_ms"], m["ops_ms"]) for m in ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   launches_per_call=[m["launches"] for m in ms])


def _kernel_name(mangled: str) -> str:
    """The name of a kernel from its mangled name: the length-prefixed
    component of the nested name that ends in "_kernel"."""
    i = mangled.find("N") + 1            # _ZN <length><name> ...
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        if mangled[j:j + n].endswith("_kernel"):
            return mangled[j:j + n]
        i = j + n
    return mangled


def ptxas_phase() -> None:
    """nvcc's report of every kernel instance: registers, spills and shared
    memory (static from ptxas; dynamic from the sources' own size functions,
    response_nms per family and tile height, FED per steps per launch)."""
    from vislam_tpu_torch.ops import build

    rnms = build.load("response_nms").response_nms_smem_bytes
    rnms.argtypes, rnms.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    fed = build.load("fed_evolve").fed_steps_smem_bytes
    fed.argtypes, fed.restype = [ctypes.c_int], ctypes.c_int
    for name in build.SOURCES:
        for fn, regs, st, ld, static in build.ptxas_report(name):
            kernel = _kernel_name(fn)
            args = [int(v) for v in re.findall(r"Li(\d+)E", fn)]
            if kernel == "response_nms_kernel":
                dyn = f"{rnms(*args)} B"                          # (family, tile rows)
            elif kernel == "fed_kernel":                        # (steps)
                dyn = f"{fed(*args)} B"
            else:
                dyn = "per launch (see the source)"
            print(f"ptxas {name}: {kernel}<{', '.join(map(str, args))}>: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B, static shared {static} B, "
                  f"dynamic shared {dyn}", flush=True)


def reset_launches() -> None:
    from vislam_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def read_launches() -> dict:
    """Every counter, and match_top2_per_pair: the match calls with an A per
    pair (a_group = 1; the single pair's or the batched step's)."""
    from vislam_tpu_torch.ops import launch_counts

    out = launch_counts()
    out["match_top2_per_pair"] = out["match_top2"] - out["match_top2_batched"]
    return out


def _config(frontend: dict, backend: dict):
    from vislam_tpu_torch.utils.config import SystemConfig

    base = SystemConfig()
    return dataclasses.replace(
        base, frontend=dataclasses.replace(base.frontend, **frontend),
        backend=dataclasses.replace(base.backend, **backend))


def _to_device(tree, dev):
    """Every tensor of a nested NamedTuple (or tuple) moved to `dev`."""
    if isinstance(tree, tuple):
        items = [_to_device(x, dev) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _response_check(fam, label, x, k_nms, k_resp, radius: int = 2) -> float:
    """The kernel's (nms, resp) of images x (B, H, W) against the plain
    twin's (NMS radius `radius`); returns the largest response error."""
    from vislam_tpu_torch.ops.harris_kernel import response_nms_plain

    p_nms, p_resp = response_nms_plain(x, fam, radius)
    torch.cuda.synchronize()
    err = (k_resp - p_resp).abs().max().item()
    scale = max(p_resp.abs().max().item(), 1.0)
    agree = 1.0 if k_nms is None else \
        (torch.isneginf(k_nms) == torch.isneginf(p_nms)).float().mean().item()
    # The tests' bounds (tests/test_ops.py): error / scale < 1e-4, NMS
    # agreement > 0.999 (float32 sums in another order may flip a near-tied
    # maximum).
    if not err / scale < 1e-4 or not agree > 0.999:
        _fail(f"response_nms {fam} disagrees at {label}: max abs err {err} (scale {scale}), "
              f"nms agreement {agree}")
    print(f"kernel response_nms {fam} {label}: max_abs_err {err:.3e} (scale {scale:.3e}), "
          f"nms agreement {agree:.6f}", flush=True)
    return err


def _ragged_cases(seq) -> list:
    """(label, (B, H, W) float32 images) off the paths' shapes: ragged
    tiles, a row, a column, a batch of two frames."""
    a = torch.as_tensor(seq["images"][1]).to(DEV, torch.float32)
    b = torch.as_tensor(seq["images"][2]).to(DEV, torch.float32)
    return [("ragged (37, 53)", a[None, :37, :53].contiguous()),
            ("ragged (1, 752)", a[None, :1].contiguous()),
            ("ragged (480, 1)", a[None, :, :1].contiguous()),
            ("batch of two (2, 480, 752)", torch.stack([a, b]))]


def _response_rows(seq):
    """Every response family against its plain twin on its path's levels,
    at every tile height the kernel has, and on the ragged cases."""
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
    ragged = _ragged_cases(seq)
    rows = []
    for fam, levels in fields.items():
        err_max = 0.0
        measures = []
        for lv in levels:
            k_nms, k_resp = response_nms(lv, fam)
            err = _response_check(fam, str(tuple(lv.shape)), lv[None],
                                  None if k_nms is None else k_nms[None], k_resp[None])
            for rows_ in TILE_ROWS:
                err_max = max(err_max, _response_check(
                    fam, f"{tuple(lv.shape)} tile rows {rows_}", lv[None],
                    *response_nms(lv[None], fam, tile_rows=rows_)))
            px = lv.numel()
            writes = 1 if fam == "_gradmag2" else 2
            measures.append(_measure(
                f"response_nms {fam} {tuple(lv.shape)}",
                lambda lv=lv, fam=fam: response_nms_plain(lv[None], fam),
                lambda lv=lv, fam=fam: response_nms(lv, fam), 4 * px * (1 + writes),
                [(RESPONSE_FLOP_PER_PX[fam] * px, "fp32",
                  f"{RESPONSE_FLOP_PER_PX[fam]} flop/px x {px} px")], 1))
            err_max = max(err_max, err)
        for label, x in ragged:
            err_max = max(err_max, _response_check(fam, label, x, *response_nms(x, fam)))
        if fam == "shi_tomasi":
            # frontend.nms_radius 1 and 3: the kernel's raw response through
            # the (2r+1)^2 NMS, as the reference routes any radius but 2.
            for lv in levels:
                for radius in (1, 3):
                    err_max = max(err_max, _response_check(
                        fam, f"{tuple(lv.shape)} nms_radius {radius}", lv[None],
                        *response_nms(lv[None], fam, radius), radius=radius))
        rows.append(_row(f"response_nms:{fam}", fam, "vislam_tpu_torch/ops/csrc/response_nms.cu",
                         "vislam_tpu/ops/harris_kernel.py:193", err_max, measures))
    return rows


def _fed_check(label, L, k, taus) -> tuple:
    """The kernel on (B, H, W) fields L with k (B,) against the plain twin;
    returns (its output, max abs error)."""
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve, fed_evolve_plain

    out = fed_evolve(L, k, taus)
    ref = fed_evolve_plain(L, k, taus)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # float32 stencils summed in another order, through n steps of a stable
    # diffusion on a 0-255 field: 1e-3 absolute is ~4e-6 relative.
    if not err < 1e-3:
        _fail(f"fed_evolve {label} disagrees: max abs err {err}")
    print(f"kernel fed_evolve {label}: max_abs_err {err:.3e}", flush=True)
    return out, err


def _fed_row(seq):
    """FED at 480x752: the 4-step cycle on the presmoothed frame and the
    8-step one on level 0, as the nonlinear scale space runs them; then
    other step counts (n = 1, 3, 5, 12: 1 to 3 launches, uneven splits), a
    batch of two with distinct k, and the ragged cases."""
    from vislam_tpu_torch.frontend.nonlinear import contrast_factor, fed_tau_steps
    from vislam_tpu_torch.frontend.pyramid import gaussian_blur
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve, fed_evolve_plain, fed_schedule

    img = torch.as_tensor(seq["images"][1]).to(DEV, torch.bfloat16)
    k = contrast_factor(img)
    L = gaussian_blur(img, 1.0).float().contiguous()
    kb = k.reshape(1)
    err_max = 0.0
    measures = []
    for T in (0.78, 3.84):
        taus = fed_tau_steps(T)
        n, px = len(taus), L.numel()
        out, err = _fed_check(f"n={n} {tuple(L.shape)} k={k.item():.4f}", L[None], kb, taus)
        # The function reads L and k and writes the field.
        measures.append(_measure(
            f"fed_evolve n={n} {tuple(L.shape)}",
            lambda L=L, taus=taus: fed_evolve_plain(L[None], kb, taus),
            lambda L=L, taus=taus: fed_evolve(L, k, taus),
            8 * px + 4, [(n * FED_FLOP_PER_PX_STEP * px, "fp32",
                          f"{n} steps x {FED_FLOP_PER_PX_STEP} flop/px x {px} px")],
            len(fed_schedule(n))))
        err_max = max(err_max, err)
        L = out[0]
    # Other step counts take the first n steps of a long cycle (all under
    # the explicit limit 0.25): a whole cycle's long last steps amplify
    # float32 round-off whatever the kernel (tests/test_torch_nonlinear.py).
    L0 = gaussian_blur(img, 1.0).float().contiguous()
    for n in (1, 3, 5, 12):
        err_max = max(err_max, _fed_check(f"n={n} {tuple(L0.shape)}", L0[None], kb,
                                          fed_tau_steps(40.0)[:n])[1])
    two = torch.stack([L0, L])
    k2 = torch.stack([k, 0.7 * k])
    err_max = max(err_max, _fed_check("n=8 batch of two, distinct k", two, k2,
                                      fed_tau_steps(3.84))[1])
    for label, x in _ragged_cases(seq):
        err_max = max(err_max, _fed_check(f"n=4 {label}", x, k.expand(x.shape[0]).contiguous(),
                                          fed_tau_steps(0.78))[1])
    return _row("fed_evolve", "fed_evolve", "vislam_tpu_torch/ops/csrc/fed_evolve.cu",
                "vislam_tpu/ops/fed_kernel.py:83", err_max, measures)


def _match_check(label, D, k, p, mask_b) -> float:
    """Kernel outputs k against the plain twin's p on the same inputs;
    returns the largest distance error."""
    err = max((k[0] - p[0]).abs().max().item(), (k[1] - p[1]).abs().max().item())
    empty = p[0] >= 5e8   # rows with no candidate: 1e9 throughout, arg1 = 0 on both sides
    if D == 128:
        # SIFT: float32 dot products summed in another order (rtol 1e-4);
        # indices exact away from near-ties.
        for name, a, b in (("min1", k[0], p[0]), ("min2", k[1], p[1])):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                _fail(f"match_top2 {name} disagrees ({label}): max abs err "
                      f"{(a - b).abs().max().item()}")
        rows_ok = empty | ((p[1] - p[0]).abs() > 1e-5 * p[0].clamp(min=1e-6))
        cols_ok, col_need = mask_b, 0.99
    else:
        # BRIEF: every distance is an exact multiple of 1/64, so distances
        # are exact and indices agree on every row and column, exact ties
        # included.
        if err != 0.0:
            _fail(f"match_top2 D=256 distances not exact ({label}): {err}")
        rows_ok = torch.ones_like(p[2], dtype=torch.bool)
        cols_ok, col_need = torch.ones_like(mask_b), 1.0
    arg_ok = (k[2] == p[2])[rows_ok].float().mean().item() if rows_ok.any() else 1.0
    col_ok = (k[3] == p[3])[cols_ok].float().mean().item() if cols_ok.any() else 1.0
    # A masked-out column holds 1e9 in every row: its argmin is row 0.
    dead_ok = torch.equal(k[3][~mask_b], p[3][~mask_b])
    ties = int(((p[1] == p[0]) & ~empty).sum().item())
    print(f"kernel match_top2 {label}: max_abs_err {err:.3e}, arg1 exact {arg_ok:.4f} of "
          f"{int(rows_ok.sum())} rows ({ties} tied at min1, {int(empty.sum())} with no candidate), "
          f"colarg {col_ok:.4f}", flush=True)
    if arg_ok < 1.0 or col_ok < col_need or not dead_ok:
        _fail(f"match_top2 indices disagree ({label}): arg1 {arg_ok}, colarg {col_ok}, "
              f"masked-out columns equal {dead_ok}")
    return err


def _match_rows(seq, gate_px):
    """match_top2 on real descriptors of two frames: SIFT-128 and BRIEF-256
    at K = 768 (2 levels) and 512 (1 level), ungated and gated at the
    rescue's disc, timed; then on cuts of the K = 768 sets: ragged shapes,
    all-invalid rows and columns, discs that hold no candidate, no valid
    row at all."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.ops.match_kernel import match_top2, match_top2_plain
    from vislam_tpu_torch.utils.config import FrontendConfig

    frontends = {128: dict(), 256: dict(scale_space="nonlinear", detector="fast",
                                        descriptor="brief")}
    rows = []
    for D, fe in frontends.items():
        err_max = 0.0
        measures, extra = [], []   # the K = 768 calls of a frame; K = 512
        for levels in (2, 1):
            fcfg = FrontendConfig(levels_used=levels, **fe)
            fa = extract_features(torch.as_tensor(seq["images"][0]).to(DEV, torch.float32), fcfg)
            fb = extract_features(torch.as_tensor(seq["images"][1]).to(DEV, torch.float32), fcfg)
            a, ma, b, mb = (x.contiguous() for x in (fa.desc, fa.mask, fb.desc, fb.mask))
            uva, uvb = fa.uv.contiguous(), fb.uv.contiguous()
            K, N = a.shape[0], b.shape[0]
            cases = [(f"K={K} N={N} D={D} gated={gated}", (a, ma, b, mb),
                      dict(uv_pred=uva, uv_b=uvb, gate_radius=gate_px) if gated else {}, True)
                     for gated in (False, True)]
            if K == 768:
                far = uva + 1000.0 * (torch.arange(K, device=DEV) % 3 == 0)[:, None]
                cases += [
                    (f"ragged K=700 N=333 D={D} gated", (a[:700], ma[:700], b[:333], mb[:333]),
                     dict(uv_pred=uva[:700], uv_b=uvb[:333], gate_radius=gate_px), False),
                    (f"ragged K=700 N=333 D={D}", (a[:700], ma[:700], b[:333], mb[:333]), {},
                     False),
                    (f"ragged K=1 N={N} D={D}", (a[:1], ma[:1], b, mb), {}, False),
                    (f"every 5th row and 7th column invalid K={K} D={D}",
                     (a, ma & (torch.arange(K, device=DEV) % 5 != 0), b,
                      mb & (torch.arange(N, device=DEV) % 7 != 0)), {}, False),
                    (f"every 3rd disc empty K={K} D={D}", (a, ma, b, mb),
                     dict(uv_pred=far.contiguous(), uv_b=uvb, gate_radius=gate_px), False),
                    (f"no valid row K={K} D={D}", (a, torch.zeros_like(ma), b, mb), {}, False),
                ]
            for label, args, gate, timed in cases:
                k = match_top2(*args, **gate)
                p = match_top2_plain(*args, **gate)
                torch.cuda.synchronize()
                err_max = max(err_max, _match_check(label, D, k, p, args[3]))
                if not timed:
                    continue
                Ka, Nb = args[0].shape[0], args[2].shape[0]
                nbytes = (4 * D + 1 + (8 if gate else 0)) * (Ka + Nb) + 12 * Ka + 4 * Nb
                per_pair = MATCH_FLOP_PER_PAIR + (GATE_FLOP_PER_PAIR if gate else 0)
                (measures if K == 768 else extra).append(_measure(
                    f"match_top2 {label}", lambda a=args, g=gate: match_top2_plain(*a, **g),
                    lambda a=args, g=gate: match_top2(*a, **g), nbytes,
                    [(3 * 2 * Ka * Nb * D, "tf32", f"3xTF32 a.b 3 x 2 x {Ka} x {Nb} x {D}"),
                     (per_pair * Ka * Nb, "fp32", f"{per_pair} x {Ka} x {Nb} per pair")], 2))
        rows.append(_row(f"match_top2:d{D}", "match_top2",
                         "vislam_tpu_torch/ops/csrc/match_top2.cu",
                         "vislam_tpu/ops/match_kernel.py:126", err_max, measures, extra))
    return rows


def _window_match_row(seq, W):
    """The window-track match of engine/refine.py: the anchor keyframe's
    descriptors, shared (stride 0), against a bank of W keyframes' in one
    batched call, the bank bfloat16 as the window keeps it, widened to
    float32 as refine widens it; timed. Then ragged W, K and N, slots
    wholly invalid, and W = 1."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.ops.match_kernel import match_top2, match_top2_plain
    from vislam_tpu_torch.utils.config import FrontendConfig

    feats = [extract_features(torch.as_tensor(seq["images"][3 * w]).to(DEV, torch.float32),
                              FrontendConfig()) for w in range(W)]
    bank = torch.stack([f.desc for f in feats]).to(torch.bfloat16).float()
    masks = torch.stack([f.mask for f in feats])
    a, ma = bank[W - 1], masks[W - 1]
    K, D = a.shape
    keep = (torch.arange(W, device=DEV) % 4 != 0)[:, None]
    cases = [
        (f"W={W} K={K} N={K} D={D} A shared", (a, ma, bank, masks), True),
        (f"ragged W=3 K=700 N=333 D={D}", (a[:700], ma[:700], bank[:3, :333].contiguous(),
                                           masks[:3, :333].contiguous()), False),
        (f"W={W} slots 0, 4, 8 all invalid", (a, ma, bank, masks & keep), False),
        (f"W=1 K={K} D={D}", (a, ma, bank[:1], masks[:1]), False),
    ]
    err_max, measures = 0.0, []
    for label, args, timed in cases:
        k = match_top2(*args)
        p = match_top2_plain(*args)
        torch.cuda.synchronize()
        for w in range(args[2].shape[0]):
            err_max = max(err_max, _match_check(f"window {label} slot {w}", D,
                                                [x[w] for x in k], [x[w] for x in p],
                                                args[3][w]))
        if not timed:
            continue
        Wb, N = args[2].shape[:2]
        # The function reads A and its mask once, every slot's B and mask,
        # and writes min1, min2, arg1 (K each) and colarg (N) per slot.
        nbytes = (4 * D + 1) * (K + Wb * N) + Wb * (12 * K + 4 * N)
        measures.append(_measure(
            f"match_top2 window {label}", lambda a=args: match_top2_plain(*a),
            lambda a=args: match_top2(*a), nbytes,
            [(2 * Wb * K * N * D, "bf16", f"bfloat16 a.b 2 x {Wb} x {K} x {N} x {D}"),
             (MATCH_FLOP_PER_PAIR * Wb * K * N, "fp32",
              f"{MATCH_FLOP_PER_PAIR} x {Wb} x {K} x {N} per pair")], 2))
    return _row("match_top2:window", "match_top2_batched",
                "vislam_tpu_torch/ops/csrc/match_top2.cu",
                "vislam_tpu/ops/match_kernel.py:126", err_max, measures)


BATCH = 8   # sequences of the batched kernel checks, as the batch8 path steps them


def _per_entry_check(label, D, k, p_of, mask_b) -> float:
    """A batched call's outputs k (leading dims (B,) or (B, W)) against the
    plain twin's single-pair outputs p_of(index) of every entry."""
    err = 0.0
    for idx in np.ndindex(*mask_b.shape[:-1]):
        err = max(err, _match_check(f"{label} entry {idx}", D, [x[idx] for x in k], p_of(idx),
                                    mask_b[idx]))
    return err


def _match_bytes(D, K, N, pairs, a_sets, gated) -> int:
    """Bytes the match function moves: each A set and each B set with its
    mask (and positions, gated) read once, min1, min2, arg1 (K) and colarg
    (N) written per pair."""
    per_row = 4 * D + 1 + (8 if gated else 0)
    return per_row * (a_sets * K + pairs * N) + pairs * (12 * K + 4 * N)


def _vmapped_match(r):
    """match_top2 under torch.func.vmap (the op's rule folds the map into
    one call of the kernel), gated at radius r > 0."""
    from vislam_tpu_torch.ops.match_kernel import match_top2

    if r > 0:
        return lambda *x: torch.func.vmap(lambda *y: match_top2(*y, gate_radius=r))(*x)
    return lambda *x: torch.func.vmap(match_top2)(*x)


def _batch_pairs(feats_a, feats_b, gate_px, note="") -> tuple:
    """match_top2 as the batched step calls it: the pairs (feats_a[i],
    feats_b[i]) under torch.func.vmap, an A each (a_group = 1), ungated
    and gated at the rescue's disc (the per-frame match and the rescue);
    each entry held against the plain twin on its single pair, timed.
    Returns (largest error, measures, the stacked (a, ma, b, mb, uva,
    uvb))."""
    from vislam_tpu_torch.ops.match_kernel import match_top2_plain

    def stack(feats, field):
        return torch.stack([getattr(f, field) for f in feats]).contiguous()

    a, ma, uva = stack(feats_a, "desc"), stack(feats_a, "mask"), stack(feats_a, "uv")
    b_, mb, uvb = stack(feats_b, "desc"), stack(feats_b, "mask"), stack(feats_b, "uv")
    (B, K, D), N = a.shape, b_.shape[1]
    measures, err = [], 0.0
    for gated in (False, True):
        r = gate_px if gated else 0.0
        args = (a, ma, b_, mb) + ((uva, uvb) if gated else ())
        label = f"batch{B} pairs K={K} N={N} D={D} gated={gated}"
        k = _vmapped_match(r)(*args)
        torch.cuda.synchronize()
        err = max(err, _per_entry_check(label + note, D, k, lambda z, args=args, r=r:
                                        match_top2_plain(*[x[z] for x in args], gate_radius=r),
                                        mb))
        per_pair = MATCH_FLOP_PER_PAIR + (GATE_FLOP_PER_PAIR if gated else 0)
        measures.append(_measure(
            f"match_top2 {label} (vmap, a_group 1)",
            lambda args=args, r=r: match_top2_plain(*args, gate_radius=r),
            lambda args=args, r=r: _vmapped_match(r)(*args), _match_bytes(D, K, N, B, B, gated),
            [(3 * 2 * B * K * N * D, "tf32", f"3xTF32 a.b 3 x 2 x {B} x {K} x {N} x {D}"),
             (per_pair * B * K * N, "fp32", f"{per_pair} x {B} x {K} x {N} per pair")], 2))
    return err, measures, (a, ma, b_, mb, uva, uvb)


def _batch_match_rows(feats, gate_px, W):
    """match_top2 as the batched step calls it, each under torch.func.vmap:
    B = 8 pairs with an A each (`_batch_pairs`); the window match of 8
    sequences (a_group = W: each sequence's anchor against its W slots, the
    bf16 bank widened as engine/refine.py widens it), each entry held
    against the plain twin on its single pair, timed. Then ragged pairs
    (B = 3, K = 700, N = 333) with an all-invalid entry, ungated and gated
    with empty discs. The custom op's own cost: the op against its
    function called directly, back-to-back."""
    from vislam_tpu_torch.ops.match_kernel import _match_op, match_top2, match_top2_plain

    B = BATCH
    err, measures, (a, ma, b_, mb, uva, uvb) = _batch_pairs(
        feats[0:2 * B:2], feats[1:2 * B:2], gate_px)
    K, D = a.shape[1:]
    # Ragged pairs; entry 1 wholly invalid; gated, every 3rd disc empty.
    far = (uva[:3, :700] + 1000.0 * (torch.arange(700, device=DEV) % 3 == 0)[:, None]).contiguous()
    mb_r = mb[:3, :333].clone()
    mb_r[1] = False
    ragged = (a[:3, :700].contiguous(), ma[:3, :700].contiguous(), b_[:3, :333].contiguous(),
              mb_r)
    for gated in (False, True):
        r = gate_px if gated else 0.0
        args = ragged + ((far, uvb[:3, :333].contiguous()) if gated else ())
        k = _vmapped_match(r)(*args)
        torch.cuda.synchronize()
        err = max(err, _per_entry_check(
            f"ragged B=3 K=700 N=333 D={D}, entry 1 all invalid"
            + (", every 3rd disc empty" if gated else ""), D, k,
            lambda z, args=args, r=r: match_top2_plain(*[x[z] for x in args], gate_radius=r),
            mb_r))
    # The op's dispatch cost per call (host time; the same single pair).
    one = (a[0], ma[0], b_[0], mb[0])
    direct = (a[:1], ma[:1], b_[:1], mb[:1], None, None, 0.0, 1)
    op_ms = _time_ms(lambda: match_top2(*one))
    fn_ms = _time_ms(lambda: _match_op._init_fn(*direct))
    print(f"kernel match_top2 custom op: {op_ms * 1e3:.2f} us per call back-to-back through "
          f"the op, {fn_ms * 1e3:.2f} us calling its function directly: "
          f"{(op_ms - fn_ms) * 1e3:.2f} us of dispatch", flush=True)
    pairs = _row("match_top2:batch8_pairs", "match_top2_per_pair",
                 "vislam_tpu_torch/ops/csrc/match_top2.cu", "vislam_tpu/ops/match_kernel.py:120",
                 err, measures)

    # The window match of B sequences: bank[b, w] a frame's descriptors.
    n = len(feats)
    bank16 = torch.stack([torch.stack([feats[(b + 2 * w) % n].desc for w in range(W)])
                          for b in range(B)]).to(torch.bfloat16)
    bank = bank16.float()
    masks = torch.stack([torch.stack([feats[(b + 2 * w) % n].mask for w in range(W)])
                         for b in range(B)])
    anchor, anchor_mask = bank[:, W - 1].contiguous(), masks[:, W - 1].contiguous()
    args = (anchor, anchor_mask, bank, masks)
    label = f"batch{B} window W={W} K={K} N={K} D={D}"
    k = _vmapped_match(0.0)(*args)
    torch.cuda.synchronize()
    err_w = _per_entry_check(label, D, k, lambda bw: match_top2_plain(
        anchor[bw[0]], anchor_mask[bw[0]], bank[bw], masks[bw]), masks)
    window = _measure(
        f"match_top2 {label} (vmap, a_group {W})",
        lambda flat=(anchor, anchor_mask, bank.flatten(0, 1), masks.flatten(0, 1)):
            match_top2_plain(*flat),
        lambda: _vmapped_match(0.0)(*args), _match_bytes(D, K, K, B * W, B, False),
        [(2 * B * W * K * K * D, "bf16", f"bfloat16 a.b 2 x {B} x {W} x {K} x {K} x {D}"),
         (MATCH_FLOP_PER_PAIR * B * W * K * K, "fp32",
          f"{MATCH_FLOP_PER_PAIR} x {B} x {W} x {K} x {K} per pair")], 2)
    for m, single in zip(measures + [window], (0.977, 1.030, 2.143)):
        bound = max(m["bytes_ms"], m["ops_ms"]) * 1e3
        print(f"kernel {m['label']}: bound {bound:.3f} us = {bound / single:.2f} x the single "
              f"call's {single} us", flush=True)
    return [pairs, _row("match_top2:batch8_window", "match_top2_batched",
                        "vislam_tpu_torch/ops/csrc/match_top2.cu",
                        "vislam_tpu/ops/match_kernel.py:126", err_w, [window])]


def _folded(fn, *args):
    """fn over the leading dim of args under torch.func.vmap (the custom
    op's rule folds it into one kernel call), its None outputs dropped."""
    return torch.func.vmap(lambda *a: tuple(o for o in fn(*a) if o is not None))(*args)


def _batch_response(fam, levels, timed=True, note="") -> tuple:
    """response_nms of family fam under torch.func.vmap over the frames of
    each (B, H, W) of levels (one folded launch per level): against the
    per-frame kernel calls stacked and against the plain twin, with the
    tests' tolerances; timed if asked. Returns (largest error against the
    twin, measures)."""
    from vislam_tpu_torch.ops.harris_kernel import response_nms, response_nms_plain

    err_max, measures = 0.0, []
    for x in levels:
        label = f"vmap B={x.shape[0]} {tuple(x.shape[1:])}"
        got = _folded(lambda im: response_nms(im, fam), x)
        each = [[o for o in response_nms(im, fam) if o is not None] for im in x]
        stacked = [torch.stack(o) for o in zip(*each)]
        torch.cuda.synchronize()
        k_nms = got[0] if fam != "_gradmag2" else None
        err_max = max(err_max, _response_check(fam, f"{label}{note} vs plain", x, k_nms,
                                               got[-1]))
        # The folded launch may pick another tile height than a single
        # frame's (the kernel chooses it from (B, H, W)): held to the
        # twin's tolerance, not to the bit.
        diff = (got[-1] - stacked[-1]).abs().max().item()
        scale = max(stacked[-1].abs().max().item(), 1.0)
        agree = 1.0 if k_nms is None else \
            (torch.isneginf(got[0]) == torch.isneginf(stacked[0])).float().mean().item()
        print(f"kernel response_nms {fam} {label}{note}: against the per-frame kernel calls "
              f"max |d resp| {diff:.3e} (scale {scale:.3e}), nms agreement {agree:.6f}",
              flush=True)
        if not diff / scale < 1e-4 or not agree > 0.999:
            _fail(f"response_nms {fam} {label}: the folded call differs from the "
                  "per-frame calls")
        if timed:
            px = x.numel()
            writes = 1 if fam == "_gradmag2" else 2
            measures.append(_measure(
                f"response_nms {fam} {label}", lambda x=x, fam=fam: response_nms_plain(x, fam),
                lambda x=x, fam=fam: _folded(lambda im: response_nms(im, fam), x),
                4 * px * (1 + writes), [(RESPONSE_FLOP_PER_PX[fam] * px, "fp32",
                                         f"{RESPONSE_FLOP_PER_PX[fam]} flop/px x {px} px")], 1))
    return err_max, measures


def _batch_response_row(seq):
    """response_nms under torch.func.vmap over B = 8 frames' levels, every
    family (`_batch_response`); shi_tomasi timed at both levels."""
    from vislam_tpu_torch.frontend.pyramid import build_pyramid
    from vislam_tpu_torch.ops.harris_kernel import FAMILIES

    pyrs = [build_pyramid(torch.as_tensor(seq["images"][i]).to(DEV, torch.bfloat16), 2)
            for i in range(BATCH)]
    levels = [torch.stack([p[lv].float() for p in pyrs]).contiguous() for lv in range(2)]
    for fam in FAMILIES:
        err, measures = _batch_response(fam, levels, timed=fam == "shi_tomasi")
        if fam == "shi_tomasi":
            row = _row("response_nms:shi_tomasi:batch8", "shi_tomasi",
                       "vislam_tpu_torch/ops/csrc/response_nms.cu",
                       "vislam_tpu/ops/harris_kernel.py:193", err, measures)
    return row


def _distinct_k_frames(seq) -> tuple:
    """(L, k): B = 8 presmoothed frames of seq and a distinct contrast
    factor each."""
    from vislam_tpu_torch.frontend.nonlinear import contrast_factor
    from vislam_tpu_torch.frontend.pyramid import gaussian_blur

    imgs = [torch.as_tensor(seq["images"][i]).to(DEV, torch.bfloat16) for i in range(BATCH)]
    L = torch.stack([gaussian_blur(im, 1.0).float() for im in imgs]).contiguous()
    k = torch.stack([contrast_factor(im) * (0.6 + 0.1 * i) for i, im in enumerate(imgs)])
    return L, k


def _batch_fed_measures(L, k, chain=False, note="") -> tuple:
    """fed_evolve under torch.func.vmap over the frames of L (B, H, W), each
    with its k, the 4- and 8-step cycles (one folded call each; chain: the
    8-step cycle on the 4-step cycle's output, as the step calls them):
    against the per-frame kernel calls stacked and the plain twin; timed.
    Returns (largest error against the twin, measures)."""
    from vislam_tpu_torch.frontend.nonlinear import fed_tau_steps
    from vislam_tpu_torch.ops.fed_kernel import fed_evolve, fed_evolve_plain, fed_schedule

    B = L.shape[0]
    err_max, measures = 0.0, []
    for T in (0.78, 3.84):
        taus = fed_tau_steps(T)
        n, px = len(taus), L.numel()
        label = f"vmap B={B} n={n} {tuple(L.shape[1:])}"
        got = torch.func.vmap(lambda f, kk: fed_evolve(f, kk, taus))(L, k)
        each = torch.stack([fed_evolve(f, kk, taus) for f, kk in zip(L, k)])
        ref = fed_evolve_plain(L, k, taus)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        diff = (got - each).abs().max().item()
        print(f"kernel fed_evolve {label}{note}: max_abs_err {err:.3e} against the plain twin, "
              f"{diff:.3e} against the per-frame kernel calls", flush=True)
        if not err < 1e-3 or not diff < 1e-3:
            _fail(f"fed_evolve {label} disagrees: {err} (plain), {diff} (per frame)")
        err_max = max(err_max, err)
        measures.append(_measure(
            f"fed_evolve {label}{note}", lambda L=L, taus=taus: fed_evolve_plain(L, k, taus),
            lambda L=L, taus=taus: torch.func.vmap(lambda f, kk: fed_evolve(f, kk, taus))(L, k),
            8 * px + 4 * B, [(n * FED_FLOP_PER_PX_STEP * px, "fp32",
                              f"{n} steps x {FED_FLOP_PER_PX_STEP} flop/px x {px} px")],
            len(fed_schedule(n))))
        if chain:
            L = got.contiguous()
    return err_max, measures


def _batch_nonlinear_rows(seqs, gate_px):
    """The kernels of batch_kaze and batch_akaze as their batched step calls
    them, each under torch.func.vmap over NONLINEAR_B frames (frame 1 of
    each of their sequences): the FED cycles (4 steps on the presmoothed
    frames, 8 on level 0, each frame's own k), the contrast statistic
    (_gradmag2 on the frames), hessian and fast on both nonlinear levels,
    and the BRIEF-256 match of each sequence's frames 0 and 1 (a_group 1),
    ungated and gated: the checks of the B = 8 rows (`_batch_fed_measures`,
    `_batch_response`, `_batch_pairs`) at these calls."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.nonlinear import contrast_factor, nonlinear_scale_space
    from vislam_tpu_torch.frontend.pyramid import gaussian_blur
    from vislam_tpu_torch.utils.config import FrontendConfig

    B = NONLINEAR_B
    imgs = [torch.as_tensor(s["images"][1]).to(DEV, torch.bfloat16) for s in seqs[:B]]
    frames = torch.stack([im.float() for im in imgs]).contiguous()
    k = torch.stack([contrast_factor(im) for im in imgs])
    L = torch.stack([gaussian_blur(im, 1.0).float() for im in imgs]).contiguous()
    err, measures = _batch_fed_measures(L, k, chain=True, note=" (batch_kaze, batch_akaze)")
    rows = [_row("fed_evolve:batch_kaze", "fed_evolve", "vislam_tpu_torch/ops/csrc/fed_evolve.cu",
                 "vislam_tpu/ops/fed_kernel.py:83", err, measures)]

    pyrs = [nonlinear_scale_space(im, 2) for im in imgs]
    nonlin = [torch.stack([p[lv] for p in pyrs]).contiguous() for lv in range(2)]
    for fam, levels, path in (("_gradmag2", [frames], "batch_kaze"),
                              ("hessian", nonlin, "batch_kaze"), ("fast", nonlin, "batch_akaze")):
        err, measures = _batch_response(fam, levels, note=f" ({path})")
        rows.append(_row(f"response_nms:{fam}:{path}", fam,
                         "vislam_tpu_torch/ops/csrc/response_nms.cu",
                         "vislam_tpu/ops/harris_kernel.py:193", err, measures))

    fcfg = FrontendConfig(scale_space="nonlinear", detector="fast", descriptor="brief")
    feats = [[extract_features(torch.as_tensor(s["images"][i]).to(DEV, torch.float32), fcfg)
              for s in seqs[:B]] for i in (0, 1)]
    err, measures, _ = _batch_pairs(feats[0], feats[1], gate_px, note=" (batch_akaze)")
    rows.append(_row("match_top2:d256:batch_akaze", "match_top2_per_pair",
                     "vislam_tpu_torch/ops/csrc/match_top2.cu",
                     "vislam_tpu/ops/match_kernel.py:120", err, measures))
    return rows


def _categorical_call(keys, index, paths, logits, shape, vmapped=False):
    """A call of the categorical op; vmapped, as the batched step calls it:
    each entry's key and logits row mapped, the frame index shared."""
    from vislam_tpu_torch.ops.threefry_kernel import threefry_categorical

    if vmapped:
        return lambda: torch.func.vmap(lambda k, lg: threefry_categorical(
            k[None], index, paths, lg[None], shape)[0])(keys, logits)
    return lambda: threefry_categorical(keys, index, paths, logits, shape)


def _categorical_check(label, keys, index, paths, logits, shape, vmapped=False):
    """The categorical kernel's indices against its twin on the card and on
    the CPU, index for index; vmapped (`_categorical_call`): one launch for
    every entry."""
    from vislam_tpu_torch.ops.threefry_kernel import (threefry_categorical,
                                                      threefry_categorical_plain)

    before = threefry_categorical.launches
    out = _categorical_call(keys, index, paths, logits, shape, vmapped)()
    if threefry_categorical.launches - before != 1:
        _fail(f"threefry_categorical {label}: {threefry_categorical.launches - before} "
              f"launches, expected 1")
    torch.cuda.synchronize()
    plain = threefry_categorical_plain(keys, index, paths, logits, shape)
    cpu = threefry_categorical_plain(keys.cpu(), index.cpu(), paths, logits.cpu(), shape)
    err = (out.reshape(plain.shape) - plain).abs().max().item()
    same = torch.equal(out.reshape(plain.shape), plain) and torch.equal(
        out.reshape(plain.shape).cpu(), cpu)
    print(f"kernel threefry_categorical {label}: {tuple(out.shape)}; indices equal to the "
          f"twin's on the card and on the CPU: {same}; max_abs_err {err}", flush=True)
    if not same:
        _fail(f"threefry_categorical {label} disagrees with its twin")
    return float(err)


def _categorical_measure(label, keys, index, paths, logits, shape, plain_launches=False,
                         vmapped=False):
    """A categorical call (`_categorical_call`): its bytes are the keys, the
    index and the logits read once and 8 bytes per drawn index written."""
    from vislam_tpu_torch.ops.threefry_kernel import threefry_categorical_plain

    rows = max(keys.shape[0], logits.shape[0]) * len(paths) * int(np.prod(shape))
    n = rows * logits.shape[-1]
    m = _measure(label, lambda: threefry_categorical_plain(keys, index, paths, logits, shape),
                 _categorical_call(keys, index, paths, logits, shape, vmapped),
                 8 * rows + 4 * logits.numel() + 8 * keys.shape[0] + 4 * index.numel(),
                 [(THREEFRY_INT32_OPS_PER_VALUE * n, "int32",
                   f"{THREEFRY_INT32_OPS_PER_VALUE} int32 ops x {n} values")], 1)
    m["count_plain"] = plain_launches
    return m


def _draw_logits(seq, fe, n: int):
    """Logits log(w + 1e-9) of real match masks on the card, as the RANSAC
    solves take them: frame 0's features against frames 1..n, ungated (the
    main solve's) and gated in the rescue's disc around frame 0's own
    pixels (the guided re-match's); each (n, K)."""
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors

    feats = [extract_features(torch.as_tensor(seq["images"][i]).to(DEV, torch.float32), fe)
             for i in range(n + 1)]
    a = feats[0]
    main = [match_descriptors(a.desc, a.mask, b.desc, b.mask, ratio=fe.ratio_thresh,
                              mutual=fe.mutual_check).mask for b in feats[1:]]
    gated = [match_descriptors(a.desc, a.mask, b.desc, b.mask, ratio=fe.ratio_thresh,
                               mutual=fe.mutual_check, uv_pred=a.uv, uv_b=b.uv,
                               gate_radius=fe.guided_fallback_px).mask for b in feats[1:]]
    print(f"phase random: logits of real match masks, frame 0 against 1..{n}: valid matches "
          f"{[int(m.sum()) for m in main]} (gated {[int(m.sum()) for m in gated]}) of "
          f"{a.mask.shape[0]}", flush=True)
    return [torch.log(torch.stack(m).float() + 1e-9).contiguous() for m in (main, gated)]


def _vision_logits(seqs):
    """batch_vision's draw inputs: its B sequences' keys (run_batch_scan at
    seed 0) and logits log(w + 1e-9) of each sequence's real match of
    frames 0 and 1 under its frontend (one level), (B, K)."""
    from vislam_tpu_torch.engine import batch_keys
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors
    from vislam_tpu_torch.utils import prng

    B = BATCH_VISION[0]
    fe = _variant_config(_batch_vision_variant()).frontend
    masks = []
    for s in seqs[:B]:
        a, b = (extract_features(torch.as_tensor(s["images"][i]).to(DEV, torch.float32), fe)
                for i in (0, 1))
        masks.append(match_descriptors(a.desc, a.mask, b.desc, b.mask, ratio=fe.ratio_thresh,
                                       mutual=fe.mutual_check).mask)
    print(f"phase random: batch_vision's logits, frame 0 against 1 of its {B} sequences: valid "
          f"matches {[int(m.sum()) for m in masks]} of {masks[0].shape[0]}", flush=True)
    return (prng.key_tensor(batch_keys(0, B), DEV),
            torch.log(torch.stack(masks).float() + 1e-9).contiguous())


def random_phase(seq, seqs, cfg_default):
    """The categorical draw kernel against its twin at the paths' shapes:
    one frame's main and rescue draws (2 x 512 of 768 each, from the frame
    key, on real match masks' logits), batch_vision's essential draw (its 4
    keys vmapped, 512 x 8 of its K, on its real logits) and the batched
    step's 8 keys and logits rows under vmap. The kernel table's rows: the
    default path's (one frame's two calls), the essential's (batch_vision's
    call) and batch8's."""
    from vislam_tpu_torch.engine import batch_keys
    from vislam_tpu_torch.engine.engine import ESSENTIAL_PATHS, MAIN_PATHS, RESCUE_PATHS
    from vislam_tpu_torch.utils import prng

    H, M = cfg_default.backend.ransac_hyps, cfg_default.frontend.max_keypoints
    base = prng.key_tensor(prng.prng_key(0)[None], DEV)
    index = torch.tensor([3], dtype=torch.int32, device=DEV)
    keys8 = prng.key_tensor(batch_keys(0, BATCH), DEV)
    index8 = index.expand(BATCH).contiguous()
    main, gated = _draw_logits(seq, cfg_default.frontend, BATCH)
    keys_v, logits_v = _vision_logits(seqs)
    Bv, Kv = logits_v.shape
    cat = [("main", MAIN_PATHS, main), ("rescue", RESCUE_PATHS, gated)]
    err = max([_categorical_check(f"frame key, {what}, 2 x {H} of {M}", base, index, paths,
                                  lg[:1], (H,)) for what, paths, lg in cat]
              + [_categorical_check(f"essential, batch_vision's {Bv} keys vmapped, {H} x 8 of "
                                    f"{Kv}", keys_v, index, ESSENTIAL_PATHS, logits_v, (H, 8),
                                    vmapped=True)]
              + [_categorical_check(f"vmapped over {BATCH} keys and logits rows, {what}",
                                    keys8, index, paths, lg, (H,), vmapped=True)
                 for what, paths, lg in cat])
    source = "vislam_tpu_torch/ops/csrc/threefry_gumbel.cu"
    replaces = {"translation": "vislam_tpu/frontend/pose.py:118-119 (jax.random.categorical, "
                               "XLA-fused; no Pallas kernel)",
                "essential": "vislam_tpu/frontend/essential.py:115 (jax.random.categorical, "
                             "XLA-fused; no Pallas kernel)"}
    return [
        _row("threefry_categorical", "threefry_categorical", source, replaces["translation"],
             err, [_categorical_measure(f"threefry_categorical {what}, 2 x {H} of {M}", base,
                                        index, paths, lg[:1], (H,), plain_launches=what == "main")
                   for what, paths, lg in cat]),
        _row("threefry_categorical:essential", "threefry_categorical", source,
             replaces["essential"], err,
             [_categorical_measure(f"threefry_categorical essential, batch_vision's {Bv} keys "
                                   f"vmapped, {H} x 8 of {Kv}", keys_v, index, ESSENTIAL_PATHS,
                                   logits_v, (H, 8), vmapped=True)]),
        _row("threefry_categorical:batch8", "threefry_categorical", source,
             replaces["translation"], err,
             [_categorical_measure(f"threefry_categorical batch8 {what}, {BATCH} x 2 x {H} of "
                                   f"{M}", keys8, index8, paths, lg, (H,))
              for what, paths, lg in cat]),
    ]


def kernel_phase(seq, seqs, cfg_default):
    """Each kernel against its plain twin at main-path shapes and data."""
    # argmin keeps the first index on ties on the card, as on the CPU.
    d = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0], device=DEV)
    if int(torch.argmin(d)) != 1 or int(torch.argmin(d.reshape(5, 1), dim=0)[0]) != 1:
        _fail("torch.argmin does not keep the first index on ties on the card")
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.utils.config import FrontendConfig

    fed = _fed_row(seq)
    fed_err, fed_vmap = _batch_fed_measures(*_distinct_k_frames(seq), note=", distinct k")
    fed["extra"] += fed_vmap
    fed["max_abs_err"] = max(fed["max_abs_err"], fed_err)
    feats = [extract_features(torch.as_tensor(seq["images"][i]).to(DEV, torch.float32),
                              FrontendConfig()) for i in range(2 * BATCH + 2)]
    return (_response_rows(seq) + [fed]
            + _match_rows(seq, cfg_default.frontend.guided_fallback_px)
            + [_window_match_row(seq, cfg_default.backend.window_size)]
            + [_batch_response_row(seq)]
            + _batch_match_rows(feats, cfg_default.frontend.guided_fallback_px,
                                cfg_default.backend.window_size)
            + _batch_nonlinear_rows(seqs, cfg_default.frontend.guided_fallback_px))


def stage_times(name, eng, state, inputs):
    """Where a frame's wall time goes: each stage alone, synchronised."""
    from vislam_tpu_torch.engine.bootstrap import vi_align_window
    from vislam_tpu_torch.engine.engine import MAIN_PATHS, FrameKey
    from vislam_tpu_torch.engine.refine import refine_window
    from vislam_tpu_torch.frontend.detect import detect_keypoints
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.frontend.match import match_descriptors
    from vislam_tpu_torch.frontend.nonlinear import nonlinear_scale_space
    from vislam_tpu_torch.frontend.pose import ransac_translation
    from vislam_tpu_torch.ops.threefry_kernel import draw_categorical
    from vislam_tpu_torch.frontend.pyramid import build_pyramid
    from vislam_tpu_torch.inertial.filters import madgwick_scan
    from vislam_tpu_torch.inertial.preintegration import preintegrate
    from vislam_tpu_torch.utils import prng

    fe = eng.cfg.frontend
    img, imu, dt = inputs.images[5], inputs.imu[5], inputs.imu_dt[5]
    kf = state.kf_feat
    feat = extract_features(img, fe, eng.geom)
    rays = torch.nn.functional.normalize(torch.randn(kf.uv.shape[0], 3, device=DEV), dim=-1)
    H, M = eng.cfg.backend.ransac_hyps, kf.uv.shape[0]
    logits = torch.log(kf.mask.float() + 1e-9)
    key = FrameKey(prng.key_tensor(prng.prng_key(0), DEV),
                   torch.zeros((), dtype=torch.int32, device=DEV))
    R = torch.eye(3, device=DEV)
    img_t = img.to(getattr(torch, fe.image_dtype))
    n_lv = min(fe.num_levels, fe.levels_used)

    def scale_space():
        if fe.scale_space == "nonlinear":
            return nonlinear_scale_space(img_t, n_lv)
        return build_pyramid(img_t, n_lv)

    pyr = scale_space()

    def wall_ms(fn):
        """Mean of 10 calls after one (5 where that one took over 0.1 s)."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = 10 if time.perf_counter() - t0 < 0.1 else 5
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
        f"draw (threefry_categorical, main, 2 x {H} of {M})": lambda: draw_categorical(
            key, MAIN_PATHS, logits, (H,)),
        f"ransac_translation ({H} x {M}, its draw included)": lambda: ransac_translation(
            rays, rays.roll(1, 0), R, kf.mask, key, uv_i=kf.uv, dispersion_pow=1.25),
    }
    en, c = eng.cfg.engine, eng.calib
    if not inputs.use_gt_scale:
        stages["vi_align_window (every frame)"] = lambda: vi_align_window(
            state, eng.R_bc, en.gravity, min_factors=en.vi_align_min_factors,
            min_excitation=en.vi_align_min_excitation,
            engage_min_excitation=en.vi_engage_min_excitation)
    if eng.cfg.backend.refine_in_step:
        stages[f"refine_window (every frame, {eng.cfg.backend.lm_iters} LM steps)"] = \
            lambda: refine_window(state, eng.cfg, c.fx, c.fy, c.cx, c.cy, R_bc=eng.R_bc)
    stages["whole step"] = lambda: eng.step(state, img, imu, dt,
                                            0.1 if inputs.use_gt_scale else -1.0)
    for stage, fn in stages.items():
        print(f"profile {name}: {stage}: {wall_ms(fn):.2f} ms wall", flush=True)


def _trace(name, n, run, unit) -> None:
    """A torch.profiler pass over run() (n frames, or n batched steps): the
    device busy share, the launches per `unit` and the kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Device rows only: an operator row carries the time of the kernels it
    # launched as well, so summing every row counts each kernel twice.
    dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    n_launch = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    print(f"profile {name}: profiled {n} {unit}s: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({dev_us / 1e6 / wall:.3f} of wall), "
          f"{n_launch} kernel launches ({n_launch / n:.0f} per {unit})", flush=True)
    print(events.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)


def trace_path(name, eng, state, inputs):
    """The trace of TRACE_FRAMES frames of a path."""
    from vislam_tpu_torch.engine import run_sequence_scan

    n = TRACE_FRAMES[name]
    sub = inputs._replace(images=inputs.images[:n], imu=inputs.imu[:n],
                          imu_dt=inputs.imu_dt[:n], gt_pos=inputs.gt_pos[:n])
    _trace(name, n, lambda: run_sequence_scan(eng, state, sub), "frame")


def _host_syncs(step) -> list:
    """Synchronizing calls inside step() (one step) under CUDA sync debug
    mode, each located by the port's innermost frame on the Python stack."""
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
        step()
        torch.cuda.set_sync_debug_mode("default")
    return syncs


def path_phase(name, seq):
    """Drive one frontend's path; returns its launch counts and, for a
    long path, what phases 4 and 7 profile (engine, state, inputs; else
    None)."""
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.eval import ate_rmse

    path = PATHS[name]
    N = path.frames
    cfg = _config(path.frontend, path.backend)
    eng = VIOEngine(seq["calib"], cfg, device=DEV)

    def init(e):
        return e.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                            v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

    inputs = make_sequence_inputs(seq, 1, 1 + N, use_gt_scale=path.gt_scale, device=DEV)
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
    if N > N_SHORT:
        # More timed runs: the spread of frames/s on this host (the step is
        # bound by the host's dispatch of small launches).
        for _ in range(path.runs - 1):
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
    what = {**path.frontend, **path.backend} or "default SystemConfig"
    print(f"path {name}: {N} frames in {elapsed:.3f} s = {N / elapsed:.2f} frames/s "
          f"({what}, K={cfg.frontend.max_keypoints}, 480x752, "
          f"{'GT scale' if path.gt_scale else 'IMU scale, GT-free'}); ATE {ate:.4f} m; "
          f"keyframes {int(kf.sum())}; solved {solved:.3f}; vi_aligned "
          f"{bool(state.vi_aligned)}, vi_engaged {bool(state.vi_engaged)}, bootstrap applies "
          f"{int(state.bootstrap_applies)}; "
          f"median matches {float(np.median(nm)):.0f}, inliers {float(np.median(ni)):.0f}; "
          f"rescues {int(res.used_fallback.sum())}; peak device memory {peak_mb:.1f} MiB; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    if len(fps) > 1:
        print(f"path {name}: frames/s over {len(fps)} runs {[round(f, 2) for f in fps]}, "
              f"median {float(np.median(fps)):.2f}", flush=True)
    if path.note:
        print(f"path {name}: {path.note}", flush=True)
    if path.latch and not bool(getattr(state, path.latch)):
        _fail(f"{name}: {path.latch} not latched by frame {N}")
    if path.accuracy:
        if not ate < 0.5:
            _fail(f"{name}: ATE {ate} >= 0.5 m")
        if not kf.sum() > 5:
            _fail(f"{name}: only {int(kf.sum())} keyframes")
        if not solved > 0.9:
            _fail(f"{name}: only {solved:.3f} of frames solved")
    for counter, n in path.per_frame.items():
        if launches[counter] != n * N:
            _fail(f"{name}: {counter} launched {launches[counter]} times over {N} frames "
                  f"(expected {n} per frame)")

    syncs = _host_syncs(lambda: eng.step(state, inputs.images[0], inputs.imu[0],
                                         inputs.imu_dt[0], 0.1 if path.gt_scale else -1.0))
    print(f"path {name}: host syncs inside one step: {len(syncs)} {sorted(set(syncs))}",
          flush=True)
    if syncs:
        _fail(f"{name}: {len(syncs)} host syncs inside a step")

    # Reference on a small input: the first frames again on the CPU (the
    # plain twins), both runs at seed 0, each drawing under its own keys
    # (the card's draw kernel and the CPU's twin give the same bits; no
    # draw is shipped across). The default path runs 20 frames, held at
    # 1e-5 m: its card and CPU runs differ only by arithmetic.
    n_ref = DEFAULT_CPU_FRAMES if name == "default" else N_SHORT
    cpu = VIOEngine(seq["calib"], cfg, seed=0, device="cpu")
    sub = inputs._replace(images=inputs.images[:n_ref], imu=inputs.imu[:n_ref],
                          imu_dt=inputs.imu_dt[:n_ref], gt_pos=inputs.gt_pos[:n_ref])
    _, r_gpu = run_sequence_scan(eng, init(eng), sub, seed=0)
    cpu_inputs = sub._replace(**{k: getattr(sub, k).cpu()
                                 for k in ("images", "imu", "imu_dt", "gt_pos")})
    _, r_cpu = run_sequence_scan(cpu, init(cpu), cpu_inputs, seed=0)
    kf_g, kf_c = r_gpu.is_keyframe.cpu(), r_cpu.is_keyframe
    dp = (r_gpu.p_wc.cpu() - r_cpu.p_wc).abs().max().item()
    dm = (r_gpu.num_matches.cpu() - r_cpu.num_matches).abs().max().item()
    print(f"path {name}: card vs CPU plain twins over {n_ref} frames at seed 0, no draws "
          f"shipped: keyframes equal {bool(torch.equal(kf_g, kf_c))}, max |dp_wc| {dp:.3e} m, "
          f"max |d matches| {dm}", flush=True)
    # The card's kernels and the CPU's plain twins round differently, which
    # can move a subpixel position or flip a near-tied match; a keyframe
    # decision or a centimetre of position cannot. On the default path the
    # two runs are held at 1e-5 m.
    bound = DEFAULT_CPU_ATOL if name == "default" else 1e-2
    if not torch.equal(kf_g, kf_c) or dp > bound or dm > 5:
        _fail(f"{name}: the card's run disagrees with the CPU plain twins")
    return launches, ((eng, state, inputs) if N > N_SHORT else None)


def _first(inputs, n):
    """The first n frames of batched (B, N, ...) inputs."""
    return inputs._replace(images=inputs.images[:, :n], imu=inputs.imu[:, :n],
                           imu_dt=inputs.imu_dt[:, :n], gt_pos=inputs.gt_pos[:, :n])


def batch_path_phase(name, seqs):
    """Drive one batched path (run_batch_scan: each frame one
    torch.func.vmap call of the step over the batch); returns its launch
    counts and what phase 7 traces (engine, state, inputs, kf_gt_pos0)."""
    from vislam_tpu_torch.engine import (
        VIOEngine,
        make_batch_inputs,
        make_sequence_inputs,
        run_batch_scan,
        run_sequence_scan,
        sequence_key,
        stack_states,
    )
    from vislam_tpu_torch.eval import ate_rmse

    bp = BATCH_PATHS[name]
    B, N = bp.sequences, bp.frames
    seqs = seqs[:B]
    cfg = _config(bp.frontend, bp.backend)
    eng = VIOEngine(seqs[0]["calib"], cfg, device=DEV)

    def init(s):
        return eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0], v_w0=s["gt_vel"][0],
                              p_w0=s["gt_pos"][0])

    per_seq = [make_sequence_inputs(s, 1, 1 + N, use_gt_scale=bp.gt_scale, device=DEV)
               for s in seqs]
    inputs = make_batch_inputs(per_seq)
    kf0 = torch.as_tensor(np.stack([s["gt_pos"][0] for s in seqs]), dtype=torch.float32,
                          device=DEV)
    # Warm-up on a short prefix (first-use library loads, allocator growth).
    run_batch_scan(eng, stack_states([init(s) for s in seqs]), _first(inputs, 2), kf0)
    state0 = stack_states([init(s) for s in seqs])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    final, res = run_batch_scan(eng, state0, inputs, kf0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    fps = [B * N / elapsed]
    for _ in range(bp.runs - 1):
        t0 = time.perf_counter()
        run_batch_scan(eng, state0, inputs, kf0)
        torch.cuda.synchronize()
        fps.append(B * N / (time.perf_counter() - t0))

    p = res.p_wc.cpu().numpy()
    if p.shape != (B, N, 3) or not np.isfinite(p).all():
        _fail(f"{name}: non-finite or misshapen poses {p.shape}")
    ates = [ate_rmse(np.concatenate([s["gt_pos"][:1], p[b]]), s["gt_pos"][: N + 1],
                     align=False) for b, s in enumerate(seqs)]
    kfs = res.is_keyframe.sum(dim=1).cpu().numpy()
    print(f"path {name}: {B} sequences x {N} frames in {elapsed:.3f} s = {B * N / elapsed:.2f} "
          f"frames/s aggregate, {N / elapsed:.2f} batched steps/s "
          f"({ {**bp.frontend, **bp.backend} or 'default SystemConfig'}, "
          f"K={cfg.frontend.max_keypoints}, 480x752, "
          f"{'GT scale' if bp.gt_scale else 'IMU scale, GT-free'}); ATE per entry min "
          f"{min(ates):.4f} / median {float(np.median(ates)):.4f} / max {max(ates):.4f} m; "
          f"keyframes per entry {kfs.min()}-{kfs.max()}; vi_engaged "
          f"{int(final.vi_engaged.sum())} of {B}; peak device memory {peak_mb:.1f} MiB; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"path {name}: aggregate frames/s over {len(fps)} runs {[round(f, 2) for f in fps]}, "
          f"median {float(np.median(fps)):.2f}", flush=True)
    if bp.note:
        print(f"path {name}: {bp.note}", flush=True)
    for counter, n in launches.items():
        if n != bp.per_step.get(counter, 0) * N:
            _fail(f"{name}: {counter} launched {n} times over {N} batched steps (expected "
                  f"{bp.per_step.get(counter, 0)} per step)")
    if bp.accuracy and not max(ates) < 0.5:
        _fail(f"{name}: ATE {max(ates)} >= 0.5 m")

    syncs = _host_syncs(lambda: run_batch_scan(eng, final, _first(inputs, 1), kf0))
    print(f"path {name}: host syncs inside one batched step: {len(syncs)} "
          f"{sorted(set(syncs))}", flush=True)
    if syncs:
        _fail(f"{name}: {len(syncs)} host syncs inside a batched step")

    # Each entry against the port's own unbatched run on the card, the
    # same keys (sequence_key), over the first frames.
    n_ref, dp, kf_equal = min(N_SHORT, N), 0.0, True
    for b, s in enumerate(seqs):
        one_in = per_seq[b]._replace(images=per_seq[b].images[:n_ref],
                                     imu=per_seq[b].imu[:n_ref],
                                     imu_dt=per_seq[b].imu_dt[:n_ref],
                                     gt_pos=per_seq[b].gt_pos[:n_ref])
        _, one = run_sequence_scan(eng, init(s), one_in, key=sequence_key(0, b))
        kf_equal &= torch.equal(one.is_keyframe, res.is_keyframe[b, :n_ref])
        dp = max(dp, (one.p_wc - res.p_wc[b, :n_ref]).abs().max().item())
    print(f"path {name}: entries vs unbatched card runs over {n_ref} frames: keyframes equal "
          f"{kf_equal}, max |dp_wc| {dp:.3e} m", flush=True)
    if not kf_equal or not dp <= 1e-3:
        _fail(f"{name}: a batch entry disagrees with its unbatched run")
    return launches, (eng, state0, inputs, kf0)


def trace_batch_path(name, eng, state0, inputs, kf0):
    """The trace of a batched path's first steps, then of one step's main
    RANSAC draw alone (every sequence's key and logits in one launch, as
    the vmapped step makes it; its launch is one of the step's)."""
    from vislam_tpu_torch.engine import batch_keys, run_batch_scan
    from vislam_tpu_torch.engine.engine import MAIN_PATHS
    from vislam_tpu_torch.ops.threefry_kernel import threefry_categorical
    from vislam_tpu_torch.utils import prng

    n = BATCH_PATHS[name].trace_steps
    sub = _first(inputs, n)
    _trace(name, n, lambda: run_batch_scan(eng, state0, sub, kf0), "batched step")
    B = inputs.images.shape[0]
    keys = prng.key_tensor(batch_keys(0, B), DEV)
    index = torch.zeros(1, dtype=torch.int32, device=DEV)
    logits = torch.log(state0.kf_feat.mask.float() + 1e-9)
    _trace(f"{name} draw", 1, lambda: threefry_categorical(
        keys, index, MAIN_PATHS, logits, (eng.cfg.backend.ransac_hyps,)), "batched step")


def refine_check(eng, state) -> None:
    """One refine_window call on the slam path's final state (VI-BA
    engaged), on the card and on the CPU from the same state: the refined
    window poses and the anchor within 1e-3 m. Then the window VI-BA alone
    on one problem (built on the CPU, copied to the card): the same number
    of LM iterations on both."""
    from vislam_tpu_torch.engine.refine import build_window_problem, refine_window, window_ba

    cfg, c = eng.cfg, eng.calib
    if not bool(state.vi_engaged):
        _fail("refine check: the slam path's final state is not engaged")
    cpu_state = _to_device(state, "cpu")
    out_g = refine_window(state, cfg, c.fx, c.fy, c.cx, c.cy, R_bc=eng.R_bc)
    out_c = refine_window(cpu_state, cfg, c.fx, c.fy, c.cx, c.cy, R_bc=eng.R_bc.cpu())

    def positions(s):
        return -torch.einsum("wji,wj->wi", s.window.R_cw, s.window.t_cw).cpu()

    moved = (positions(out_c) - positions(cpu_state)).abs().max().item()
    dp = max((positions(out_g) - positions(out_c)).abs().max().item(),
             (out_g.p_wc.cpu() - out_c.p_wc).abs().max().item())
    ba_state, prob, _ = build_window_problem(cpu_state, cfg, c.fx, c.fy, c.cx, c.cy)
    info_c = window_ba(cpu_state, cfg, ba_state, prob, eng.R_bc.cpu())[-1]
    info_g = window_ba(state, cfg, _to_device(ba_state, DEV), _to_device(prob, DEV),
                       eng.R_bc)[-1]
    its = (int(info_g["iters_run"]), int(info_c["iters_run"]))
    costs = (float(info_g["final_cost"]), float(info_c["final_cost"]),
             float(info_c["initial_cost"]))
    print(f"refine check: refine_window card vs CPU: max |dp| {dp:.3e} m (the refine moved the "
          f"window {moved:.3e} m); window VI-BA on one problem: iterations card {its[0]}, CPU "
          f"{its[1]}; final cost card {costs[0]:.6g}, CPU {costs[1]:.6g} (initial "
          f"{costs[2]:.6g}); {int(prob.obs_mask.sum())} observations", flush=True)
    if not dp <= 1e-3 or its[0] != its[1]:
        _fail("refine check: the card's window refine disagrees with the CPU's")


# ---------------------------------------------------------------- phase cli

# --synthetic 21 (cut from 61, the default path's sequence, and the fixtures
# with it) and SLAM mode over 6 frames (cut from 20): the run under three
# quarters of its 1200 s limit on a slow host. A synthetic sequence's IMU
# depends on its length, so phase cli makes its own sequence of 21 frames.
CLI_FRAMES = 21
CLI_SLAM_FRAMES = 6
CLI_SUBPROCESS_FRAMES = 8
CLI_KITTI_FRAMES = 31
# Frames of the KITTI card-vs-CPU check: its near-tie count is fixed by the
# data over these frames (_kitti_card_vs_cpu), so it keeps them when the
# CPU references are cut to N_SHORT.
KITTI_CHECK_FRAMES = 10


def _cli(argv, what):
    """The port CLI's main(argv) in this process; returns its report."""
    from vislam_tpu_torch import cli

    report = {}
    try:
        rc = cli.main(argv, report=report)
    except SystemExit as e:
        rc = e.code
    if rc != 0:
        _fail(f"cli {what}: exit status {rc}")
    rows = report["rows"]
    p = np.array([r["est_p"] for r in rows], np.float64)
    if p.ndim != 2 or not np.isfinite(p).all():
        _fail(f"cli {what}: non-finite or missing poses")
    return report


def _rows_equal(what, a, b, atol=1e-5):
    """Two runs' rows: the same frames and keyframes, positions within atol."""
    fa, fb = [r["frame"] for r in a], [r["frame"] for r in b]
    if fa != fb:
        _fail(f"cli {what}: frames {fa[:3]}... vs {fb[:3]}...")
    kf_eq = [r["is_kf"] for r in a] == [r["is_kf"] for r in b]
    dp = float(np.abs(np.array([r["est_p"] for r in a], np.float64)
                      - np.array([r["est_p"] for r in b], np.float64)).max())
    print(f"cli {what}: {len(a)} rows, keyframes equal {kf_eq}, max |dp| {dp:.3e} m",
          flush=True)
    if not kf_eq or not dp <= atol:
        _fail(f"cli {what}: the two runs disagree")


def _pipelined_syncs(what, eng, state, image, imu, dt, gt_p):
    """Host syncs inside one step_pipelined call (a pinned uint8 image,
    numpy IMU and GT), after one call that warms it."""
    img = torch.from_numpy(image).pin_memory()
    eng.step_pipelined(state, gt_p, img, imu, dt, gt_p, 1.0)[-1].cpu()
    syncs = _host_syncs(lambda: eng.step_pipelined(state, gt_p, img, imu, dt, gt_p, 1.0))
    print(f"cli {what}: host syncs inside one step_pipelined: {len(syncs)} "
          f"{sorted(set(syncs))}", flush=True)
    if syncs:
        _fail(f"cli {what}: {len(syncs)} host syncs inside step_pipelined")


def _distorted_euroc_fixture(root, frames):
    """The EuRoC layout (1 s static IMU prefix) with radial distortion
    synthesised on its images, as tests/test_cli_distorted.py makes it, and
    its OpenCV-XML calibration; returns (directory, xml, calib)."""
    from vislam_tpu_torch.calib import remap_bilinear, write_opencv_xml
    from vislam_tpu_torch.calib.camera_model import undistort_normalized
    from vislam_tpu_torch.data import SyntheticConfig, synthetic_calib, write_euroc_fixture
    from vislam_tpu_torch.data.png import read_png_grey, write_png

    path = os.path.join(root, "euroc")
    write_euroc_fixture(path, SyntheticConfig(n_frames=frames, n_landmarks=300, seed=0),
                        static_prefix_s=1.0)
    clean = synthetic_calib()
    dist = (-0.15, 0.03, 0.0, 0.0)
    vv, uu = np.meshgrid(np.arange(clean.height), np.arange(clean.width), indexing="ij")
    xd = np.stack([(uu - clean.cx) / clean.fx, (vv - clean.cy) / clean.fy], -1)
    xn = undistort_normalized(torch.from_numpy(xd.astype(np.float32)), dist, iters=10)
    maps = torch.stack([xn[..., 0] * clean.fx + clean.cx, xn[..., 1] * clean.fy + clean.cy],
                       -1).to(DEV)
    cam = os.path.join(path, "mav0", "cam0", "data")
    for name in sorted(os.listdir(cam)):
        img = torch.from_numpy(read_png_grey(os.path.join(cam, name))).to(DEV)
        warped = remap_bilinear(img, maps).clamp(0, 255).to(torch.uint8).cpu().numpy()
        write_png(os.path.join(cam, name), warped)
    calib = dataclasses.replace(clean, dist=dist)
    xml = os.path.join(root, "euroc.xml")
    write_opencv_xml(xml, calib)
    return path, xml, calib


def _kitti_fixture(root, frames):
    """tests/test_cli_kitti.py's KITTI layout (no IMU), its XML; returns
    (directory, xml)."""
    from scipy.spatial.transform import Rotation as Rsp

    from vislam_tpu_torch.calib import write_opencv_xml
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence, synthetic_calib
    from vislam_tpu_torch.data.png import write_png

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=frames, n_landmarks=300, seed=15))
    path = os.path.join(root, "kitti")
    img_dir = os.path.join(path, "sequences", "00", "image_0")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(path, "poses"))
    for i, img in enumerate(seq["images"]):
        write_png(os.path.join(img_dir, f"{i:06d}.png"), img)
    np.savetxt(os.path.join(path, "sequences", "00", "times.txt"), np.arange(frames) * 0.05,
               fmt="%.6f")
    with open(os.path.join(path, "poses", "00.txt"), "w") as f:
        for q, p in zip(seq["gt_quat"], seq["gt_pos"]):
            R = Rsp.from_quat(np.roll(q, -1)).as_matrix()
            f.write(" ".join(f"{x:.9f}" for x in np.hstack([R, p[:, None]]).reshape(-1)) + "\n")
    xml = os.path.join(root, "kitti.xml")
    write_opencv_xml(xml, synthetic_calib())
    return path, xml


def _rotation_angle(A, B) -> float:
    """The angle (rad) of the rotation A^T B, from its skew part and trace
    (accurate near 0, where the arccos of the trace is not)."""
    M = A.double().cpu().T @ B.double().cpu()
    w = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    return float(torch.atan2(torch.linalg.vector_norm(w), (torch.trace(M) - 1.0) / 2.0))


def _kitti_card_vs_cpu(path, xml):
    """The KITTI run's first N_SHORT frames (stage_dataset), stepped in the
    CLI's configuration (vision-only rotation, one level) on the card and,
    frame by frame from the card's state, on the CPU, with the same key
    (the card's kernel and the CPU's twin draw the same bits, with no draws
    shipped across). Each frame's essential RANSAC is solved again on
    the CPU from the card's own rays: it must give the card's solve
    (inliers equal, rotation within 1e-4 rad, t_dir within 1e-3). Keyframes
    must be equal; where the two devices' solves agree, positions within
    1e-3 m. Where they do not, the frame must have two solutions of
    near-equal support, which the features' last-bit rounding (kernel
    against twin) picks one or the other of: each such frame's card and CPU
    inlier counts must be within 1. Their number is held too, at most 3 of
    10: with the seed fixed, the frames near a tie are fixed by the data
    (frames 5, 7 and 9 on every card run so far; 2 and 5 under the torch
    generator's draws the check used before), so a fourth is a change of
    the step, not of round-off.
    Then the host syncs of one step_pipelined."""
    import vislam_tpu_torch.engine.engine as tengine
    from vislam_tpu_torch.calib import load_opencv_xml
    from vislam_tpu_torch.data import KittiDataset
    from vislam_tpu_torch.engine import VIOEngine, stage_dataset
    from vislam_tpu_torch.engine.engine import FrameKey
    from vislam_tpu_torch.frontend.essential import ransac_essential
    from vislam_tpu_torch.utils import prng

    cfg = _config(dict(levels_used=1), {})
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine, vision_rotation=True))
    ds, calib = KittiDataset(path, "00"), load_opencv_xml(xml)
    fw0 = ds.frame_window(1)
    card, cpu = VIOEngine(calib, cfg, device=DEV), VIOEngine(calib, cfg, device="cpu")
    st = card.initialize(fw0.image, q_wb0=fw0.gt_quat, p_w0=fw0.gt_pos)
    inputs = stage_dataset(ds, 2, 2 + KITTI_CHECK_FRAMES, device=DEV)
    kf_gt = torch.as_tensor(fw0.gt_pos, dtype=torch.float32).to(DEV)
    solves = []

    def key_on(dev, n):
        return FrameKey(prng.key_tensor(prng.prng_key(0), dev),
                        torch.tensor(n, dtype=torch.int32).to(dev))

    def spy(*args, **kw):
        out = ransac_essential(*args, **kw)
        solves.append((args, kw, out))
        return out

    tengine.ransac_essential = spy
    try:
        kf_eq, dp_agree, ambiguous, solve_err = True, 0.0, [], [0.0, 0.0]
        for n in range(KITTI_CHECK_FRAMES):
            gt_norm = torch.linalg.vector_norm(inputs.gt_pos[n] - kf_gt)
            frame = [inputs.images[n], inputs.imu[n], inputs.imu_dt[n]]
            st_next, r_g = card._step(st, *frame, gt_norm, key_on(DEV, n))
            args, kw, s_g = solves[-1]
            _, r_c = cpu._step(_to_device(st, "cpu"), *[x.cpu() for x in frame], gt_norm.cpu(),
                               key_on("cpu", n))
            s_c = solves[-1][2]
            s_x = ransac_essential(*[x.cpu() for x in args],
                                   **{k: _to_device(v, "cpu") for k, v in kw.items()})
            err = (_rotation_angle(s_g.R_ji, s_x.R_ji),
                   float((s_g.t_dir.cpu() - s_x.t_dir).abs().max()))
            solve_err = [max(a, b) for a, b in zip(solve_err, err)]
            if int(s_g.num_inliers) != int(s_x.num_inliers) or err[0] > 1e-4 or err[1] > 1e-3:
                _fail(f"cli kitti: frame {n}: the card's essential solve differs from the "
                      f"CPU's on the card's own rays")
            kf_eq &= bool(r_g.is_keyframe) == bool(r_c.is_keyframe)
            if float((s_g.t_dir.cpu() - s_c.t_dir).abs().max()) < 1e-3:
                dp_agree = max(dp_agree, float((r_g.p_wc.cpu() - r_c.p_wc).abs().max()))
            else:
                ambiguous.append((n, int(s_g.num_inliers), int(s_c.num_inliers)))
            kf_gt = torch.where(r_g.is_keyframe, inputs.gt_pos[n], kf_gt)
            st = st_next
    finally:
        tengine.ransac_essential = ransac_essential
    print(f"cli kitti: card vs CPU over {KITTI_CHECK_FRAMES} frames, each from the card's "
          f"state with the same key: keyframes equal {kf_eq}; the card's essential solve "
          f"against the CPU's on the card's rays: inliers equal, max rotation "
          f"{solve_err[0]:.2e} rad, max |d t_dir| {solve_err[1]:.2e}; where the devices' "
          f"solves agree max |dp_wc| {dp_agree:.3e} m; frames with another near-equal-"
          f"support solve (frame, card inliers, CPU inliers) {ambiguous}", flush=True)
    near_tie = all(abs(card_n - cpu_n) <= 1 for _, card_n, cpu_n in ambiguous)
    if not kf_eq or not dp_agree <= 1e-3 or not near_tie or len(ambiguous) > 3:
        _fail("cli kitti: the card's run disagrees with the CPU's")
    fw = ds.frame_window(2)
    _pipelined_syncs("kitti", card, st, fw.image, fw.imu, fw.imu_dt, fw.gt_pos)


def cli_phase() -> None:
    """The port's CLI (vislam_tpu_torch/cli.py) on the card: a. the
    synthetic host loop against the sequence loop on the CLI's sequence; b.
    a distorted EuRoC fixture, host loop and --scan; c. SLAM mode through
    the CLI; d. a KITTI fixture (vision-only rotation) against the CPU; e.
    checkpoint and resume; f. the CLI as a subprocess. Each check fatal."""
    import tempfile

    from vislam_tpu_torch import cli
    from vislam_tpu_torch.calib import compute_undistort_maps, remap_bilinear
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.data.png import read_png_grey
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.utils.config import SystemConfig

    # The sequence `--synthetic CLI_FRAMES` makes.
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=CLI_FRAMES, n_landmarks=300, seed=0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # a. The synthetic host loop (CLI) and the sequence loop on one sequence.
        n = CLI_FRAMES - 1
        eng = VIOEngine(seq["calib"], SystemConfig(), device=DEV)

        def init(e):
            return e.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                                v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

        inputs = make_sequence_inputs(seq, 1, CLI_FRAMES, device=DEV)
        run_sequence_scan(eng, init(eng), inputs._replace(
            images=inputs.images[:3], imu=inputs.imu[:3], imu_dt=inputs.imu_dt[:3],
            gt_pos=inputs.gt_pos[:3]))
        scan_fps, scan_res = [], None
        for _ in range(3):
            st0 = init(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, res = run_sequence_scan(eng, st0, inputs)
            torch.cuda.synchronize()
            scan_fps.append(n / (time.perf_counter() - t0))
            scan_res = scan_res or res
        loop_fps, drain_ms, reports = [], [], []
        for k in range(3):
            reset_launches()
            rep = _cli(["--synthetic", str(CLI_FRAMES), "--output",
                        os.path.join(tmp, f"a{k}.csv")], "synthetic")
            if k == 0:
                launches = read_launches()
            loop_fps.append(rep["frames"] / rep["wall"])
            t = rep["timer"]
            drain_ms.append(1e3 * t.total["drain"] / t.count["drain"])
            reports.append(rep)
        rows = reports[0]["rows"]
        scan_rows = [dict(frame=j + 1, is_kf=bool(scan_res.is_keyframe[j]),
                          est_p=scan_res.p_wc[j].cpu().numpy()) for j in range(n)]
        _rows_equal("synthetic host loop vs run_sequence_scan", rows, scan_rows)
        # initialize: one extraction (2 response launches); the warm-up step
        # and the n frames: the default path's launches each.
        per_frame = {c: (launches[c] - (2 if c == "shi_tomasi" else 0)) / (n + 1)
                     for c in PATHS["default"].per_frame}
        print(f"cli synthetic: {n} frames, host loop (step_pipelined, bursts of "
              f"{cli.PIPE_BURST}) "
              f"{[round(f, 2) for f in loop_fps]} frames/s, median "
              f"{float(np.median(loop_fps)):.2f}; run_sequence_scan "
              f"{[round(f, 2) for f in scan_fps]}, median {float(np.median(scan_fps)):.2f}; "
              f"drain {float(np.median(drain_ms)):.3f} ms per burst (median of the runs' means); "
              f"ATE {reports[0]['ate']:.4f} m; launches per frame {per_frame}", flush=True)
        if per_frame != PATHS["default"].per_frame:
            _fail(f"cli synthetic: launches per frame {per_frame}, the default path's are "
                  f"{PATHS['default'].per_frame}")
        if not reports[0]["ate"] < 0.5:
            _fail(f"cli synthetic: ATE {reports[0]['ate']} >= 0.5 m")
        imu = inputs.imu[0].cpu().numpy()
        dt = inputs.imu_dt[0].cpu().numpy()
        _pipelined_syncs("synthetic", eng, init(eng), seq["images"][1], imu, dt,
                         seq["gt_pos"][1].astype(np.float32))

        # b. A distorted EuRoC fixture: host loop, the remap, --scan.
        t0 = time.perf_counter()
        path, xml, calib = _distorted_euroc_fixture(tmp, CLI_FRAMES)
        print(f"cli euroc: fixture of {CLI_FRAMES} frames with distortion written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rep = _cli(["--dataset", path, "--calibration", xml, "--output",
                    os.path.join(tmp, "b.csv")], "euroc")
        scan = _cli(["--dataset", path, "--calibration", xml, "--scan", "--output",
                     os.path.join(tmp, "bs.csv")], "euroc --scan")
        maps, _ = compute_undistort_maps(calib)
        cam = os.path.join(path, "mav0", "cam0", "data")
        img = read_png_grey(os.path.join(cam, sorted(os.listdir(cam))[5]))
        on_card = remap_bilinear(torch.from_numpy(img).to(DEV),
                                 torch.from_numpy(maps).to(DEV)).cpu()
        remap_err = (on_card - remap_bilinear(torch.from_numpy(img),
                                              torch.from_numpy(maps))).abs().max().item()
        t = rep["timer"]
        print(f"cli euroc: {rep['frames']} frames at {rep['frames'] / rep['wall']:.2f} frames/s "
              f"(host loop); ATE {rep['ate']:.4f} m; undistort remap card vs CPU max abs err "
              f"{remap_err:.3e} grey levels; frame read (PNG decode + IMU/GT, prefetch thread) "
              f"{1e3 * rep['read_s'] / rep['frames_read']:.3f} ms per frame; undistort "
              f"{t.mean_ms('undistort'):.3f} ms, drain {t.mean_ms('drain'):.3f} ms per burst; "
              f"--scan {scan['frames']} frames in {scan['wall']:.3f} s", flush=True)
        if not remap_err <= 1e-3:
            _fail(f"cli euroc: remap card vs CPU {remap_err}")
        if rep["ate"] is None or not rep["ate"] < 0.5:
            _fail(f"cli euroc: ATE {rep['ate']}")
        _rows_equal("euroc host loop vs --scan", rep["rows"], scan["rows"])

        # c. SLAM mode through the CLI (--imu-scale: the window VI-BA).
        reset_launches()
        rep = _cli(["--dataset", path, "--calibration", xml, "--imu-scale", "--end",
                    str(2 + CLI_SLAM_FRAMES), "--output", os.path.join(tmp, "c.csv")],
                   "euroc --imu-scale")
        launches = read_launches()
        print(f"cli slam: {rep['frames']} frames (--imu-scale, GT-free, window VI-BA) at "
              f"{rep['frames'] / rep['wall']:.2f} frames/s; ATE {rep['ate']:.4f} m; launches "
              f"{ {k: v for k, v in launches.items() if v} } (cut in depth from 20 frames to "
              f"{CLI_SLAM_FRAMES}, the CLI's sequence from 61 to {CLI_FRAMES}, to keep the run "
              f"under three quarters of its limit)", flush=True)
        if rep["frames"] != CLI_SLAM_FRAMES or \
                launches["match_top2_batched"] != CLI_SLAM_FRAMES + 1:
            _fail(f"cli slam: {rep['frames']} frames, {launches['match_top2_batched']} window "
                  f"matches (expected {CLI_SLAM_FRAMES} and one per step, warm-up included)")

        # d. A KITTI fixture: vision-only rotation.
        kpath, kxml = _kitti_fixture(tmp, CLI_KITTI_FRAMES)
        rep = _cli(["--dataset", kpath, "--format", "kitti", "--calibration", kxml, "--output",
                    os.path.join(tmp, "d.csv")], "kitti")
        print(f"cli kitti: {rep['frames']} frames (vision-only rotation) at "
              f"{rep['frames'] / rep['wall']:.2f} frames/s; ATE {rep['ate']:.4f} m "
              f"(not bounded: the KITTI mode has no IMU)", flush=True)
        _kitti_card_vs_cpu(kpath, kxml)

        # e. Checkpoint at frame 10, resume to 20: the uninterrupted run's tail.
        ck = os.path.join(tmp, "state.npz")
        _cli(["--synthetic", str(n // 2 + 1), "--checkpoint", ck, "--output",
              os.path.join(tmp, "e1.csv")], "checkpoint")
        rep = _cli(["--synthetic", str(CLI_FRAMES), "--checkpoint", ck, "--resume", "--output",
                    os.path.join(tmp, "e2.csv")], "resume")
        _rows_equal("resume vs uninterrupted", rep["rows"], rows[-len(rep["rows"]):])
        if len(rep["rows"]) != n // 2:
            _fail(f"cli resume: {len(rep['rows'])} rows, expected {n // 2}")

        # f. The entry point alone, as a user starts it.
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vislam_tpu_torch.cli", "--synthetic",
                               str(CLI_SUBPROCESS_FRAMES), "--output", os.path.join(tmp, "f.csv")],
                              capture_output=True, text=True, timeout=300)
        ate = re.search(r"ATE RMSE \(unaligned\): ([0-9.]+) m", proc.stdout)
        print(f"cli subprocess: python -m vislam_tpu_torch.cli --synthetic "
              f"{CLI_SUBPROCESS_FRAMES}: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; "
              f"{ate.group(0) if ate else 'no ATE line'}", flush=True)
        if proc.returncode != 0 or ate is None:
            _fail(f"cli subprocess failed: {proc.stderr[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- phase map

MAP_FRAMES = 86        # EVAL config 4's sequence (seed 21): the path revisits its start at frame 80
MAP_OUTAGE = (44, 28, 36, 30)   # tests/test_reloc.py:109: frames, vision blanked [28, 36), drift at 30
# The --load-map --reloc run, cut from 86 frames to 21 (the map loads
# before the first frame) to keep the run under three quarters of its limit.
MAP_RELOC_FRAMES = 21
MAP_NODES = 315        # EVAL config 6's keyframes (its 500-frame run)
MAP_LOOPS = 8
# EVAL config 4's correct_trajectory settings (scripts/eval_configs.py::run_vio)
# and its result in the reference (EVAL.md: max keyframe error before -> after).
EVAL4_KW = dict(min_separation=10, sim_thresh=0.80, min_inliers=25)
EVAL4_ERR = (0.267, 0.146)


def _loops_agree(a, b) -> bool:
    """Equal loop pairs, inliers within 2 (a near-tied ratio test may flip
    between the kernel and the twin)."""
    return [x[:2] for x in a] == [y[:2] for y in b] and \
        all(abs(x[2] - y[2]) <= 2 for x, y in zip(a, b))


def _nonzero(launches) -> dict:
    return {k: v for k, v in launches.items() if v}


def _map_loop_check() -> None:
    """a. EVAL config 4's inputs: the scan, its keyframe archive
    (keyframes_from_scan), correct_trajectory in SE(3) and Sim(3) on the card
    against the CPU on the same archive, each kernel's launches as the host
    counts them."""
    from vislam_tpu_torch.backend.loop import detect_loop_candidates, global_descriptors
    from vislam_tpu_torch.backend.trajectory_opt import (
        correct_trajectory, keyframes_from_scan, to_device,
    )
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.utils.config import SystemConfig

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=MAP_FRAMES, n_landmarks=300,
                                                  seed=21))
    c = seq["calib"]
    eng = VIOEngine(c, SystemConfig(), device=DEV)
    state0 = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=seq["gt_vel"][0],
                            p_w0=seq["gt_pos"][0])
    inputs = make_sequence_inputs(seq, 1, MAP_FRAMES, device=DEV)
    _, res = run_sequence_scan(eng, state0, inputs)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    archive = keyframes_from_scan(inputs.images, res, eng.cfg.frontend, frame_offset=1,
                                  geom=eng.geom)
    arch_ms = 1e3 * (time.perf_counter() - t0) / max(len(archive), 1)
    n_kf, launches = len(archive), read_launches()
    print(f"map loop: {MAP_FRAMES - 1} frames scanned, {n_kf} keyframes archived by "
          f"keyframes_from_scan at {arch_ms:.3f} ms per keyframe (extraction + one copy); "
          f"launches {_nonzero(launches)} (2 shi_tomasi per keyframe expected)", flush=True)
    if launches != {**{k: 0 for k in launches}, "shi_tomasi": 2 * n_kf} or n_kf <= 10:
        _fail(f"map loop: {n_kf} keyframes, launches {_nonzero(launches)}")

    desc, mask = to_device(DEV, np.stack([k.desc for k in archive]),
                           np.stack([k.kp_mask for k in archive]))
    cands = detect_loop_candidates(global_descriptors(desc, mask),
                                   torch.ones(n_kf, dtype=torch.bool, device=DEV),
                                   min_separation=EVAL4_KW["min_separation"],
                                   sim_thresh=EVAL4_KW["sim_thresh"])
    measured = sum(1 for a, m in zip(cands.idx_a.tolist(), cands.mask.tolist())
                   if m and a + 1 < n_kf)
    kf_gt = np.array([seq["gt_pos"][k.frame_index] for k in archive])
    before = float(np.linalg.norm(np.stack([k.p_wc for k in archive]) - kf_gt, axis=-1).max())
    for graph in ("se3", "sim3"):
        kw = dict(EVAL4_KW, use_sim3=graph == "sim3")
        reset_launches()
        p, _, info = correct_trajectory(archive, c.fx, c.fy, c.cx, c.cy, **kw, device=DEV)
        launches = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        correct_trajectory(archive, c.fx, c.fy, c.cx, c.cy, **kw, device=DEV)
        ms = 1e3 * (time.perf_counter() - t0)
        p_cpu, _, info_cpu = correct_trajectory(archive, c.fx, c.fy, c.cx, c.cy, **kw,
                                                device="cpu")
        after = float(np.linalg.norm(p - kf_gt, axis=-1).max())
        dp = float(np.abs(p - p_cpu).max())
        print(f"map loop {graph}: loops {info['loops']} (CPU {info_cpu['loops']}); max keyframe "
              f"error {before:.3f} -> {after:.3f} m (the reference, EVAL.md config 4: "
              f"{EVAL4_ERR[0]} -> {EVAL4_ERR[1]} m); card vs CPU max |dp| {dp:.3e} m; "
              f"correct_trajectory {ms:.1f} ms on the card ({n_kf} keyframes, {measured} "
              f"candidates measured); launches {_nonzero(launches)}", flush=True)
        if launches != {**{k: 0 for k in launches}, "match_top2": 2 * measured,
                        "match_top2_per_pair": 2 * measured}:
            _fail(f"map loop {graph}: launches {_nonzero(launches)}, expected match_top2 "
                  f"{2 * measured} (2 per candidate measured)")
        if not any(b - a >= 10 for a, b, _ in info["loops"]) or not after < before:
            _fail(f"map loop {graph}: no loop spanning 10 keyframes, or the error did not fall")
        if not _loops_agree(info["loops"], info_cpu["loops"]) or not dp <= 1e-3:
            _fail(f"map loop {graph}: the card's correction disagrees with the CPU's")


def _main_printing(argv, what):
    """_cli(argv) with what it printed kept (and printed); returns (report, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = _cli(argv, what)
    text = buf.getvalue()
    print(text, end="", flush=True)
    return rep, text


def _map_cli_check(tmp) -> None:
    """b. The CLI with --loop-correct --save-map, then --load-map --reloc; the
    host loop's frames/s beside the same run without map flags (one each:
    printed, not bounded); the map read by plain numpy."""
    mp = os.path.join(tmp, "map.npz")
    fps = {"plain": [], "map": []}
    for k, kind in enumerate(("plain", "map")):
        extra = ["--loop-correct", "--save-map", mp] if kind == "map" else []
        reset_launches()
        rep, text = _main_printing(["--synthetic", str(MAP_FRAMES), *extra, "--output",
                                    os.path.join(tmp, f"m{k}.csv")], f"map {kind}")
        fps[kind].append(rep["frames"] / rep["wall"])
        if kind == "map":
            launches, map_rep, map_text = read_launches(), rep, text
    for line in ("loop closures: ", "map saved: "):
        if line not in map_text:
            _fail(f"map cli: no '{line}' line")
    t = map_rep["timer"]
    n_arch = len(map_rep["archive"])
    print(f"map cli: host loop {[round(f, 2) for f in fps['map']]} frames/s with --loop-correct "
          f"--save-map, {[round(f, 2) for f in fps['plain']]} without (printed only); archive "
          f"{t.mean_ms('map.archive'):.3f} ms per keyframe ({n_arch} keyframes, one copy each "
          f"after the burst's fetch); loop.correct {t.mean_ms('loop.correct'):.1f} ms; "
          f"launches of the map run {_nonzero(launches)}", flush=True)
    with np.load(mp) as z:
        kinds = {k: z[k].dtype.str for k in z.files}
        n_map = len(z["frame_index"])
    want = {"version": "<i8", "frame_index": "<i8", "R_wc": "<f4", "p_wc": "<f4", "uv": "<f4",
            "desc": "<f4", "kp_mask": "|b1"}
    print(f"map cli: {mp} read by numpy: {n_map} keyframes, {kinds}", flush=True)
    if kinds != want or n_map != n_arch:
        _fail(f"map cli: the saved map's keys and dtypes {kinds} are not the reference's")
    _, text = _main_printing(["--synthetic", str(MAP_RELOC_FRAMES), "--load-map", mp,
                              "--reloc", "--output", os.path.join(tmp, "m2.csv")],
                             "map --reloc")
    if f"loaded map: {n_map} keyframes" not in text:
        _fail("map cli: no 'loaded map' line")


def _map_reloc_check() -> None:
    """c. tests/test_reloc.py:109's outage on the card: vision blanked, drift
    injected, then attempt_relocalization on the card and on the CPU with
    the same archive and live features; the host syncs of one attempt."""
    from vislam_tpu_torch.backend.reloc import attempt_relocalization
    from vislam_tpu_torch.backend.trajectory_opt import record_from_feat
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.frontend.features import extract_features
    from vislam_tpu_torch.utils.config import SystemConfig

    n, lo_out, hi_out, at = MAP_OUTAGE
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=n, n_landmarks=300, seed=0))
    c = seq["calib"]
    eng = VIOEngine(c, SystemConfig(), device=DEV)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=seq["gt_vel"][0],
                           p_w0=seq["gt_pos"][0])
    archive, last_kf, j_live = [], 0, n - 5
    drift = torch.tensor([0.5, -0.3, 0.2], device=DEV)
    for j in range(1, j_live + 1):
        imu = np.zeros((16, 6), np.float32)
        imu[:10] = np.concatenate([seq["imu_gyro"][(j - 1) * 10:j * 10],
                                   seq["imu_accel"][(j - 1) * 10:j * 10]], -1)
        dt = np.zeros(16, np.float32)
        dt[:10] = 1 / 200.0
        img = np.zeros_like(seq["images"][j]) if lo_out <= j < hi_out else seq["images"][j]
        gt_norm = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        state, res = eng.step(state, img, imu, dt, gt_norm)
        if bool(res.is_keyframe):
            last_kf = j
            if j < lo_out:
                archive.append(record_from_feat(j, state.kf_R_wc, state.kf_p_wc, state.kf_feat))
        if j == at:
            state = state._replace(p_wc=state.p_wc + drift, kf_p_wc=state.kf_p_wc + drift)
    gt = seq["gt_pos"][j_live]
    err_before = float(np.linalg.norm(state.p_wc.cpu().numpy() - gt))
    f = extract_features(torch.from_numpy(seq["images"][j_live]).to(DEV, torch.float32),
                         eng.cfg.frontend, eng.geom)
    live = (f.uv, f.desc, f.mask)
    args = (archive, c.fx, c.fy, c.cx, c.cy)
    attempt_relocalization(*live, *args, device=DEV)       # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = attempt_relocalization(*live, *args, device=DEV)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    syncs = _host_syncs(lambda: attempt_relocalization(*live, *args, device=DEV))
    r_cpu = attempt_relocalization(*[x.cpu() for x in live], *args, device="cpu")
    if not r.success or not r_cpu.success:
        _fail(f"map reloc: relocalization failed (card {r.success}, CPU {r_cpu.success})")
    state = eng.relocalize(state, seq["images"][j_live], r.R_wc, r.p_wc)
    err_after = float(np.linalg.norm(state.p_wc.cpu().numpy() - gt))
    dp = float(np.abs(r.p_wc - r_cpu.p_wc).max())
    print(f"map reloc: {len(archive)} archived keyframes, outage frames {lo_out}-{hi_out - 1}, "
          f"drift at {at}; frame {j_live}: relocalized against archive entry {r.kf_index} "
          f"(CPU {r_cpu.kf_index}), {r.n_inliers} inliers (CPU {r_cpu.n_inliers}), rmse "
          f"{r.rmse:.3f} px; error {err_before:.3f} -> {err_after:.3f} m; card vs CPU max "
          f"|dp| {dp:.3e} m; one attempt {ms:.1f} ms, {len(syncs)} host syncs "
          f"{sorted(set(syncs))}; launches {_nonzero(launches)}", flush=True)
    if not err_after < 0.5 * err_before or r.kf_index != r_cpu.kf_index or not dp <= 1e-3:
        _fail("map reloc: the relocalization is off, or the card's disagrees with the CPU's")


def _pose_graph_problem(rng):
    """A drifted chain of MAP_NODES keyframes (two laps of a 20 m circle,
    odometry noise 0.002 rad and 0.01 m per step) and MAP_LOOPS loop edges
    from the ground truth between the laps (weight 5): (R, t, edge_i,
    edge_j, edge_R, edge_t, edge_w, t_gt) as float32 numpy."""
    from scipy.spatial.transform import Rotation as Rsp

    N = MAP_NODES
    ang = np.linspace(0, 4 * np.pi, N, endpoint=False)
    R_gt = Rsp.from_euler("z", (ang + np.pi / 2)[:, None]).as_matrix()
    t_gt = np.stack([20 * np.cos(ang), 20 * np.sin(ang), 0.5 * np.sin(3 * ang)], -1)
    dR = np.einsum("nji,njk->nik", R_gt[:-1], R_gt[1:])
    dt = np.einsum("nji,nj->ni", R_gt[:-1], t_gt[1:] - t_gt[:-1])
    noise_R = Rsp.from_rotvec(rng.normal(scale=0.002, size=(N - 1, 3))).as_matrix()
    noise_t = rng.normal(scale=0.01, size=(N - 1, 3))
    R, t = [R_gt[0]], [t_gt[0]]
    for k in range(N - 1):
        t.append(R[-1] @ (dt[k] + noise_t[k]) + t[-1])
        R.append(R[-1] @ noise_R[k] @ dR[k])
    li = np.linspace(N // 2, N - 1, MAP_LOOPS).astype(np.int32)
    lj = (li - N // 2).astype(np.int32)
    ei = np.concatenate([np.arange(N - 1), li]).astype(np.int32)
    ej = np.concatenate([np.arange(1, N), lj]).astype(np.int32)
    eR = np.concatenate([np.einsum("nji,njk->nik", np.array(R[:-1]), np.array(R[1:])),
                         np.einsum("nji,njk->nik", R_gt[li], R_gt[lj])])
    et = np.concatenate([np.einsum("nji,nj->ni", np.array(R[:-1]), np.diff(np.array(t), axis=0)),
                         np.einsum("nji,nj->ni", R_gt[li], t_gt[lj] - t_gt[li])])
    w = np.concatenate([np.ones(N - 1), np.full(MAP_LOOPS, 5.0)])
    f32 = [np.asarray(x, np.float32) for x in (R, t)]
    return (*f32, ei, ej, eR.astype(np.float32), et.astype(np.float32), w.astype(np.float32),
            t_gt)


def _map_graph_check() -> None:
    """d. SE(3) and Sim(3) pose graphs at EVAL config 6's size on the card
    against the CPU, 0 host syncs inside each, wall ms of each.

    Tolerance: the optimum is fixed only as far as the float32 cost resolves
    it. Along the chain's weakest direction (normal-matrix eigenvalue 7.6e-7
    against 19 at the top), moving every node by up to 1 cm changes the cost
    by 8e-9, under the round-off of its float32 sum (1.4e-3 over 322 edges,
    ~3e-8): so the final costs agree to 1e-4 relative, positions to 1e-2 m,
    rotation entries and scales to 1e-3."""
    from vislam_tpu_torch.backend.pose_graph import PoseGraph, optimize_pose_graph
    from vislam_tpu_torch.backend.sim3_graph import Sim3Graph, optimize_sim3_graph

    R, t, ei, ej, eR, et, w, t_gt = _pose_graph_problem(np.random.default_rng(0))
    N, E = R.shape[0], ei.shape[0]

    def graph_of(graph, dev):
        T = [torch.from_numpy(x).to(dev) for x in (R, t, ei, ej, eR, et, w)]
        if graph == "se3":
            return PoseGraph(*T)
        ones = [torch.ones(n, device=dev) for n in (N, E)]
        return Sim3Graph(*T[:2], ones[0], *T[2:6], ones[1], T[6])

    def run(g):
        if isinstance(g, PoseGraph):
            out, info = optimize_pose_graph(g, iters=15)
            return out.t, out.R, torch.ones_like(out.t[:, 0]), info["final_cost"]
        out, info = optimize_sim3_graph(g, iters=15)
        return out.t, out.R, out.s, info["final_cost"]

    for graph in ("se3", "sim3"):
        g = graph_of(graph, DEV)
        run(g)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(g)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        syncs = _host_syncs(lambda: run(g))
        cpu = run(graph_of(graph, "cpu"))
        d = [float((a.cpu() - b).abs().max()) for a, b in zip(out[:3], cpu[:3])]
        dc = abs(float(out[3]) - float(cpu[3])) / float(cpu[3])
        err = [float(np.linalg.norm(x - t_gt, axis=-1).max()) for x in (t, out[0].cpu().numpy())]
        print(f"map graph {graph}: N = {N} nodes ({(6 if graph == 'se3' else 7) * N} unknowns), "
              f"{E} edges ({MAP_LOOPS} loops), 15 iterations: {[round(x, 1) for x in ms]} ms "
              f"on the card (median {float(np.median(ms)):.1f}); {_nvidia_smi()}; drift "
              f"{err[0]:.3f} -> {err[1]:.3f} m; card vs CPU: final cost {dc:.2e} relative, "
              f"max |dt| {d[0]:.2e} m, |dR| {d[1]:.2e}, |ds| {d[2]:.2e}; host syncs inside "
              f"{len(syncs)} {sorted(set(syncs))}", flush=True)
        if syncs or not (dc <= 1e-4 and d[0] <= 1e-2 and max(d[1:]) <= 1e-3) \
                or not err[1] < 0.5 * err[0]:
            _fail(f"map graph {graph}: host syncs, card vs CPU beyond tolerance, or no "
                  f"correction")


# Sim(3)'s W in float32 against float64 (tests/test_torch_map_lie.py's
# bound and grid: theta, |sigma| in {0} u logspace(-8, 0), rotations near pi).
SIM3_W_BOUND = 4e-7


def _map_sim3_W_check() -> None:
    """e. Sim(3) exp's W on the card in float32 against the same function
    in float64 on the CPU (its series truncation moves W by at most 1.8e-8)
    over the tests' grid; the largest error overall and in the band
    1e-6 <= max(theta, |sigma|) <= 1e-2, where the reference's closed forms
    cancel, each within SIM3_W_BOUND."""
    from vislam_tpu_torch.lie.sim3 import _sim3_W

    mags = np.concatenate([[0.0], np.logspace(-8, 0, 33)])
    thetas = np.concatenate([mags, [np.pi - 1e-3, np.pi - 1e-5]])
    th, sg = [a.ravel() for a in np.meshgrid(thetas, np.concatenate([mags, -mags[1:]]))]
    axis = np.random.default_rng(0).normal(size=(len(th), 3))
    phi = (axis / np.linalg.norm(axis, axis=-1, keepdims=True) * th[:, None]).astype(np.float32)
    sigma = sg.astype(np.float32)
    W32 = _sim3_W(torch.from_numpy(phi).to(DEV), torch.from_numpy(sigma).to(DEV)).cpu().double()
    W64 = _sim3_W(torch.from_numpy(phi).double(), torch.from_numpy(sigma).double())
    err = (W32 - W64).abs().amax((-1, -2)).numpy()
    r = np.maximum(np.linalg.norm(phi.astype(np.float64), axis=-1), np.abs(sigma))
    band = (r >= 1e-6) & (r <= 1e-2)
    print(f"map sim3 W: card float32 against float64 over {len(th)} (theta, sigma): largest "
          f"|dW| {err.max():.2e} (band 1e-6..1e-2: {err[band].max():.2e} over {band.sum()}), "
          f"held <= {SIM3_W_BOUND:.0e}", flush=True)
    if not err.max() <= SIM3_W_BOUND:
        _fail("map sim3 W: float32 W beyond its bound on the card")


def map_phase() -> None:
    """The map backend on the card: a. loop correction (EVAL config 4's
    inputs); b. the CLI's map flags; c. relocalization after an outage;
    d. pose graphs at EVAL config 6's size; e. Sim(3)'s W in float32.
    Each check fatal."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_map_")
    try:
        t0 = time.perf_counter()
        _map_loop_check()
        _phase("map a (loop correction)", t0)
        t0 = time.perf_counter()
        _map_cli_check(tmp)
        _phase("map b (cli)", t0)
        t0 = time.perf_counter()
        _map_reloc_check()
        _phase("map c (relocalization)", t0)
        t0 = time.perf_counter()
        _map_graph_check()
        _phase("map d (pose graphs)", t0)
        t0 = time.perf_counter()
        _map_sim3_W_check()
        _phase("map e (sim3 W)", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------- phase variants
@dataclasses.dataclass(frozen=True)
class VariantPath:
    """A step option's path: its sequence ("seq0": seed 0, 300 landmarks;
    "seq3": EVAL config 3's), frames, overrides, GT or IMU scale, the
    launches per frame of every counter (every other 0), how its first
    N_SHORT frames are checked on the CPU ("scan": both devices run them
    from the true initial state; "per_frame": each CPU step starts from
    the card's state before it), at how many window-BA LM iterations (0:
    the path's own) and at what tolerance, the reference's ATE
    on the same run (`scripts/variant_reference_ate.py`, the JAX package
    on the CPU), EVAL config 3's regenerated row it corresponds to, and
    whether the ATE is bounded (where the reference meets 0.5 m)."""

    per_frame: dict
    frames: int
    sequence: str = "seq0"
    frontend: dict = dataclasses.field(default_factory=dict)
    backend: dict = dataclasses.field(default_factory=dict)
    engine: dict = dataclasses.field(default_factory=dict)
    gt_scale: bool = True
    cpu_check: str = "scan"
    check_lm_iters: int = 0
    atol: float = 2e-3
    ref_ate: float = 0.0
    eval_row: str = ""
    bounded: bool = True
    note: str = ""       # printed with the path (a cut)
    prior: bool = False  # the marg prior in place by the last frame, or fail


# Per frame, besides each level's response: the main match and the gated
# rescue (gated match: the main match only); the in-step window refine
# adds the window match (one batched call).
_VARIANT_STEP = {"shi_tomasi": 2, "match_top2": 2, "match_top2_per_pair": 2,
                 "match_top2_gated": 1, **DRAW}
_WINDOW = {"match_top2": 3, "match_top2_batched": 1}
# EVAL config 3's rows regenerated on the JAX package at this tree's parent
# (scripts/variant_reference_ate.py: scripts/eval_configs.py's run_vio).
EVAL3 = {"3 plain": 0.1076, "3 +photometric": 0.1040}
_VARIANT_CUT = ("cut in depth from 60 frames to 30 to pay for the marg variant's prior; the "
                "option acts on every frame")
VARIANT_PATHS = {
    "oriented": VariantPath(_VARIANT_STEP, 30, frontend=dict(oriented=True), ref_ate=0.0851,
                            note=_VARIANT_CUT),
    "gated": VariantPath({"shi_tomasi": 2, "match_top2": 1, "match_top2_per_pair": 1,
                          "match_top2_gated": 1, **DRAW_ONE}, 30,
                         frontend=dict(guided_gate_px=30.0),
                         ref_ate=0.1914, note=_VARIANT_CUT),
    # The refine amplifies round-off (the reference against itself moves
    # 1.25e-2 m under a 2-ulp image change): tier-1's 2.5e-2 m.
    "photometric": VariantPath(_VARIANT_STEP, 59, "seq3", engine=dict(photometric_refine=True),
                               atol=2.5e-2, ref_ate=0.1032, eval_row="3 +photometric"),
    # EVAL 3b's configuration: GT-free SLAM mode on its sequence. The VI-BA
    # engages with the 20th keyframe (frame 26 in the reference), the first
    # eviction after it puts the prior in place (frame 28), and from then on
    # the prior frees slot 0 and enters every keyframe's window solve.
    "marg": VariantPath({**_VARIANT_STEP, **_WINDOW}, 34, "seq3", gt_scale=False,
                        backend=dict(vi_factors=True, refine_in_step=True, online_gauge="marg"),
                        atol=1e-2, ref_ate=0.0588, prior=True,
                        note="cut in depth from EVAL 3b's 59 frames to 34, six keyframes past "
                             "the prior's first (63 s on a fast host at 59), to keep the run "
                             "under three quarters of its limit"),
    # Vision only at GT scale: past ~4 LM iterations a window pinned only
    # by slot 0 drifts along a weak direction (2.4e-2 m card vs CPU on one
    # frame at 12, PR 9 run 1; the reference moves 1.1e-4 m under 2 ulps,
    # tests/test_torch_variants_gauges.py). So the check steps each frame
    # from the card's state at 4 iterations, as tier-1 holds this refine.
    "oldest2": VariantPath({**_VARIANT_STEP, **_WINDOW}, 12,
                           backend=dict(refine_in_step=True, online_gauge="oldest2"),
                           cpu_check="per_frame", check_lm_iters=4, atol=1e-2,
                           ref_ate=0.6561, bounded=False,
                           note="cut in depth from 30 frames to 12 to keep the run under "
                                "three quarters of its limit"),
}
BATCH_VISION = (4, 20)      # sequences (seeds 0 to 3), frames
BATCH_VISION_REF_ATE = (0.9977, 1.1544, 1.0870, 0.8511)
# Per batched step: one level, the main match, the essential draw, no rescue.
BATCH_VISION_STEP = {"shi_tomasi": 1, "match_top2": 1, "match_top2_per_pair": 1, **DRAW_ONE}


def _variant_config(vp):
    from vislam_tpu_torch.utils.config import SystemConfig

    base = SystemConfig()
    return dataclasses.replace(
        base, frontend=dataclasses.replace(base.frontend, **vp.frontend),
        backend=dataclasses.replace(base.backend, **vp.backend),
        engine=dataclasses.replace(base.engine, **vp.engine))


def _launches_equal(name, launches, per, steps) -> None:
    for counter, n in launches.items():
        if n != per.get(counter, 0) * steps:
            _fail(f"{name}: {counter} launched {n} times over {steps} steps (expected "
                  f"{per.get(counter, 0)} per step)")


def _frame_draws(eng, n):
    """The main and rescue draws of frames 0 to n - 1 at seed 0, made on the
    CPU by the draw op's twin (the card's kernel draws the same bits)."""
    from vislam_tpu_torch.engine.engine import MAIN_PATHS, RESCUE_PATHS, FrameKey, draw_fields
    from vislam_tpu_torch.utils import prng

    H, M = eng.cfg.backend.ransac_hyps, eng.cfg.frontend.max_keypoints
    base = prng.key_tensor(prng.prng_key(0), "cpu")
    out = []
    for k in range(n):
        f = draw_fields(FrameKey(base, torch.tensor(k, dtype=torch.int32)),
                        MAIN_PATHS + RESCUE_PATHS, (H, M))
        out.append((f[:2], f[2:]))
    return out


def _variant_cpu_check(name, vp, eng, init, inputs) -> None:
    """The first N_SHORT frames on the CPU at the card's seed, so with its
    draws (a run of the whole prefix draws under its own keys; a run one
    frame at a time is given each frame's draws, made on the CPU) (with
    vp.check_lm_iters, both devices at that many LM iterations)."""
    from vislam_tpu_torch.engine import VIOEngine, run_sequence_scan

    cfg = eng.cfg
    if vp.check_lm_iters:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, lm_iters=vp.check_lm_iters))
        eng = VIOEngine(eng.calib, cfg, device=DEV)
    cpu = VIOEngine(eng.calib, cfg, device="cpu")
    sub = _first_frames(inputs, N_SHORT)
    cpu_in = sub._replace(**{k: getattr(sub, k).cpu()
                             for k in ("images", "imu", "imu_dt", "gt_pos")})
    if vp.cpu_check == "scan":
        _, r_gpu = run_sequence_scan(eng, init(eng), sub)
        _, r_cpu = run_sequence_scan(cpu, init(cpu), cpu_in)
        kf_g, kf_c = r_gpu.is_keyframe.cpu(), r_cpu.is_keyframe
        dp = (r_gpu.p_wc.cpu() - r_cpu.p_wc).abs().max().item()
    else:
        noises = _frame_draws(eng, N_SHORT)
        state, kf_gt = init(eng), init(eng).p_wc.clone()
        kf_g, kf_c, dps = [], [], []
        for k in range(N_SHORT):
            one = _first_frames(sub, k + 1, start=k)
            one_cpu = _first_frames(cpu_in, k + 1, start=k)
            draw = noises[k:k + 1]
            _, r_c = run_sequence_scan(cpu, _to_device(state, "cpu"), one_cpu,
                                       kf_gt_pos0=kf_gt.cpu(), noises=draw)
            state, r_g = run_sequence_scan(eng, state, one, kf_gt_pos0=kf_gt,
                                           noises=[(a.to(DEV), b.to(DEV)) for a, b in draw])
            kf_gt = torch.where(r_g.is_keyframe[0], one.gt_pos[0], kf_gt)
            kf_g.append(bool(r_g.is_keyframe[0]))
            kf_c.append(bool(r_c.is_keyframe[0]))
            dps.append((r_g.p_wc[0].cpu() - r_c.p_wc[0]).abs().max().item())
        kf_g, kf_c, dp = torch.tensor(kf_g), torch.tensor(kf_c), max(dps)
        print(f"variant {name}: per frame, card vs CPU |dp| {[f'{d:.1e}' for d in dps]} m",
              flush=True)
    print(f"variant {name}: card vs CPU plain twins over {N_SHORT} frames "
          f"({'each from the card state' if vp.cpu_check == 'per_frame' else 'one run each'}"
          f"{f', both at {vp.check_lm_iters} LM iterations' if vp.check_lm_iters else ''}): "
          f"keyframes equal {bool(torch.equal(kf_g, kf_c))}, max |dp_wc| {dp:.3e} m "
          f"(tolerance {vp.atol:g})", flush=True)
    if not torch.equal(kf_g, kf_c) or not dp <= vp.atol:
        _fail(f"variant {name}: the card's run disagrees with the CPU plain twins")


def _first_frames(inputs, n, start=0):
    return inputs._replace(images=inputs.images[start:n], imu=inputs.imu[start:n],
                           imu_dt=inputs.imu_dt[start:n], gt_pos=inputs.gt_pos[start:n])


def variant_path(name, seqs) -> tuple:
    """Drive one step option's path; returns what the trace replays."""
    from vislam_tpu_torch.engine import VIOEngine, make_sequence_inputs, run_sequence_scan
    from vislam_tpu_torch.eval import ate_rmse

    vp = VARIANT_PATHS[name]
    seq, N = seqs[vp.sequence], vp.frames
    eng = VIOEngine(seq["calib"], _variant_config(vp), device=DEV)

    def init(e):
        return e.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                            v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])

    inputs = make_sequence_inputs(seq, 1, 1 + N, use_gt_scale=vp.gt_scale, device=DEV)
    run_sequence_scan(eng, init(eng), _first_frames(inputs, 3))     # warm-up
    state0 = init(eng)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, res = run_sequence_scan(eng, state0, inputs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    p = res.p_wc.cpu().numpy()
    if p.shape != (N, 3) or not np.isfinite(p).all():
        _fail(f"variant {name}: non-finite or misshapen poses {p.shape}")
    ate = ate_rmse(np.concatenate([seq["gt_pos"][:1], p]), seq["gt_pos"][: N + 1], align=False)
    kf = int(res.is_keyframe.sum())
    extra = f"; EVAL config {vp.eval_row}: {EVAL3[vp.eval_row]} m" if vp.eval_row else ""
    print(f"variant {name}: {N} frames in {elapsed:.3f} s = {N / elapsed:.2f} frames/s "
          f"(one run; {dict(**vp.frontend, **vp.backend, **vp.engine)}, "
          f"{'GT scale' if vp.gt_scale else 'IMU scale, GT-free'}, sequence {vp.sequence}, "
          f"K={eng.cfg.frontend.max_keypoints}, 480x752); ATE {ate:.4f} m beside the "
          f"reference's {vp.ref_ate} m on the same run{extra}"
          f"{'' if vp.bounded else ' (not bounded: the reference is over 0.5 m)'}; "
          f"keyframes {kf}; vi_engaged {bool(state.vi_engaged)}; marg prior trace "
          f"{float(torch.trace(state.marg_H)):.3g}; rescues {int(res.used_fallback.sum())}; "
          f"launches {_nonzero(launches)}", flush=True)
    if vp.note:
        print(f"variant {name}: {vp.note}", flush=True)
    _launches_equal(f"variant {name}", launches, vp.per_frame, N)
    if vp.bounded and not ate < 0.5:
        _fail(f"variant {name}: ATE {ate} >= 0.5 m (the reference's {vp.ref_ate})")
    if vp.prior and not (bool(state.vi_engaged) and float(torch.trace(state.marg_H)) > 0.0):
        _fail(f"variant {name}: no marg prior in place by frame {N}")
    syncs = _host_syncs(lambda: eng.step(state, inputs.images[0], inputs.imu[0],
                                         inputs.imu_dt[0], 0.1 if vp.gt_scale else -1.0))
    print(f"variant {name}: host syncs inside one step: {len(syncs)} {sorted(set(syncs))}",
          flush=True)
    if syncs:
        _fail(f"variant {name}: {len(syncs)} host syncs inside a step")
    _variant_cpu_check(name, vp, eng, init, inputs)
    return eng, state0, inputs


def _batch_vision_variant():
    return VariantPath({}, BATCH_VISION[1], frontend=dict(levels_used=1),
                       engine=dict(vision_rotation=True))


def batch_vision_path(seqs) -> tuple:
    """run_batch_scan with vision-only rotation (the KITTI mode: one level,
    the essential solve), B sequences (seeds 0 to B - 1) x N frames; each
    entry against its unbatched card run."""
    from vislam_tpu_torch.engine import (
        VIOEngine, make_batch_inputs, make_sequence_inputs, run_batch_scan, run_sequence_scan,
        sequence_key, stack_states,
    )
    from vislam_tpu_torch.eval import ate_rmse

    B, N = BATCH_VISION
    seqs = seqs[:B]
    vp = _batch_vision_variant()
    eng = VIOEngine(seqs[0]["calib"], _variant_config(vp), device=DEV)

    def init(s):
        return eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0], v_w0=s["gt_vel"][0],
                              p_w0=s["gt_pos"][0])

    per_seq = [make_sequence_inputs(s, 1, 1 + N, device=DEV) for s in seqs]
    inputs = make_batch_inputs(per_seq)
    kf0 = torch.as_tensor(np.stack([s["gt_pos"][0] for s in seqs]), dtype=torch.float32,
                          device=DEV)
    run_batch_scan(eng, stack_states([init(s) for s in seqs]), _first(inputs, 2), kf0)
    state0 = stack_states([init(s) for s in seqs])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, res = run_batch_scan(eng, state0, inputs, kf0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    p = res.p_wc.cpu().numpy()
    if p.shape != (B, N, 3) or not np.isfinite(p).all():
        _fail(f"variant batch_vision: non-finite or misshapen poses {p.shape}")
    ates = [ate_rmse(np.concatenate([s["gt_pos"][:1], p[b]]), s["gt_pos"][: N + 1],
                     align=False) for b, s in enumerate(seqs)]
    print(f"variant batch_vision: {B} sequences x {N} frames in {elapsed:.3f} s = "
          f"{B * N / elapsed:.2f} frames/s aggregate (one run; vision-only rotation, one "
          f"level, K={eng.cfg.frontend.max_keypoints}, GT scale); ATE per entry "
          f"{[round(a, 4) for a in ates]} m beside the reference's run_batch_scan "
          f"{list(BATCH_VISION_REF_ATE)} (not bounded: over 0.5 m in both); keyframes per "
          f"entry {res.is_keyframe.sum(dim=1).tolist()}; launches {_nonzero(launches)}",
          flush=True)
    print("variant batch_vision: cut from the batch paths' 8 x 60 to 4 x 20 in depth and "
          "batch, to keep phase variants near 150 s", flush=True)
    _launches_equal("variant batch_vision", launches, BATCH_VISION_STEP, N)
    syncs = _host_syncs(lambda: run_batch_scan(eng, final, _first(inputs, 1), kf0))
    print(f"variant batch_vision: host syncs inside one batched step: {len(syncs)} "
          f"{sorted(set(syncs))}", flush=True)
    if syncs:
        _fail(f"variant batch_vision: {len(syncs)} host syncs inside a batched step")
    # Each entry against its unbatched card run on the same draws. A frame
    # whose essential solve has two near-equal-support solutions may take
    # the other one from last-bit rounding (phase cli d): such frames
    # (translation directions > 1e-3 apart at inliers within 3) are
    # counted, at most 2, and positions are held up to an entry's first.
    other, dp, kf_equal = 0, 0.0, True
    for b, s in enumerate(seqs):
        _, one = run_sequence_scan(eng, init(s), per_seq[b], key=sequence_key(0, b))
        kf_equal &= torch.equal(one.is_keyframe, res.is_keyframe[b])
        diff = (one.t_dir_cam - res.t_dir_cam[b]).abs().amax(-1).cpu() > 1e-3
        if (diff & ((one.num_inliers - res.num_inliers[b]).abs().cpu() > 3)).any():
            _fail(f"variant batch_vision: entry {b} solves differently at unequal support")
        upto = int(torch.argmax(diff.int())) if diff.any() else N
        other += int(diff.sum())
        dp = max(dp, (one.p_wc[:upto] - res.p_wc[b, :upto]).abs().max().item() if upto else 0)
    print(f"variant batch_vision: entries vs unbatched card runs over {N} frames: keyframes "
          f"equal {kf_equal}, max |dp_wc| {dp:.3e} m (up to an entry's first frame on the other "
          f"solve), frames on the other solve {other} of {B * N}", flush=True)
    if not kf_equal or not dp <= 1e-3 or other > 2:
        _fail("variant batch_vision: a batch entry disagrees with its unbatched run")
    return (eng, state0, inputs, kf0), launches


def variants_phase(seq, seqs):
    """Phase variants: each step option on the card (see the docstring);
    returns what phase 7 traces and batch_vision's launches."""
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence

    by_name = {"seq0": seq, "seq3": make_synthetic_sequence(SyntheticConfig(
        n_frames=60, n_landmarks=350, seed=1, trans_amp=(2.0, 1.4, 0.7),
        rot_amp=(0.12, 0.15, 0.3)))}
    out = {}
    for name in VARIANT_PATHS:
        t0 = time.perf_counter()
        out[name] = variant_path(name, by_name)
        _phase(f"variants {name}", t0)
    t0 = time.perf_counter()
    out["batch_vision"], launches = batch_vision_path(seqs)
    _phase("variants batch_vision", t0)
    return out, launches


# The SLAM-mode variant paths are not traced: one frame's trace of the
# slam path took 21 s (PR 8 run 3) and their launches are its (~23k).
# Neither are oriented and gated (~5 s each): their steps are the default
# path's with one option, whose launches the counters hold exactly.
TRACE_VARIANTS = ("photometric", "batch_vision")


def trace_variants(ctx) -> None:
    """One frame of each TRACE_VARIANTS path (one batched step of
    batch_vision) under torch.profiler: launches per frame, device busy
    share."""
    from vislam_tpu_torch.engine import run_batch_scan, run_sequence_scan

    for name in TRACE_VARIANTS:
        c = ctx[name]
        if name == "batch_vision":
            eng, state0, inputs, kf0 = c
            _trace(f"variant {name}", 1,
                   lambda: run_batch_scan(eng, state0, _first(inputs, 1), kf0), "batched step")
        else:
            eng, state0, inputs = c
            _trace(f"variant {name}", 1,
                   lambda: run_sequence_scan(eng, state0, _first_frames(inputs, 1)), "frame")


# ------------------------------------------------------------- phase parallel

PAR_W, PAR_L = 10, 512   # __graft_entry__.dryrun_multichip's shapes: the window
                         # (BackendConfig.window_size), landmarks per rank (max_landmarks)
PAR_ITERS = 4            # the dryrun's LM iterations
PAR_RANKS = 4            # ranks sharing the card under gloo
# EVAL config 2's sequence (seed 0, 300 landmarks), cut from 81 frames to 31
# for the script's time: 14 keyframes (a CPU run), so the window of 10 is full.
PAR_CLI_FRAMES = 31
# batch8's configuration cut from 60 frames to 24, then to 6 to keep the run
# under three quarters of its limit, over 4 ranks x 2
PAR_BATCH = (8, 6)
_PAR_LMS = ("vision", "vi", "vi_bias")
# Per rank of --dist-ba: the window-track match, one batched call.
_PAR_REFINE = {"match_top2": 1, "match_top2_batched": 1}


def _dryrun_problems(n):
    """__graft_entry__.dryrun_multichip's two problems at W = 10, L = 512 n
    (numpy, the same draws): the vision-only window (landmarks perturbed by
    5 cm) and the visual-inertial one with its scale corrupted by 0.8 (its
    initial velocities and exact IMU factors)."""
    rng = np.random.default_rng(0)
    W, L = PAR_W, PAR_L * n
    f32 = np.float32
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(5, 10, L)], -1)
    intr = dict(fx=400.0, fy=400.0, cx=376.0, cy=240.0)
    R_cw = np.tile(np.eye(3, dtype=f32), (W, 1, 1))
    t_cw = np.zeros((W, 3), f32)
    t_cw[:, 0] = -0.2 * np.arange(W)

    def project(R, t):
        Xc = np.einsum("wij,lj->wli", R, X) + t[:, None, :]
        return np.stack([intr["fx"] * Xc[..., 0] / Xc[..., 2] + intr["cx"],
                         intr["fy"] * Xc[..., 1] / Xc[..., 2] + intr["cy"]], -1).astype(f32)

    mask = np.ones((W, L), bool)
    vision = dict(R=R_cw, t=t_cw, X=(X + rng.normal(scale=0.05, size=X.shape)).astype(f32),
                  obs=project(R_cw, t_cw), mask=mask, **intr)
    G = np.array([0.0, 0.0, -9.81], f32)
    dt = 0.4
    ts = np.arange(W) * dt
    p = np.stack([0.2 * ts, 0.05 * np.sin(ts), 0.02 * ts], -1).astype(f32)
    v = np.gradient(p, dt, axis=0).astype(f32)
    yaw = 0.05 * ts
    R_wb = np.zeros((W, 3, 3), f32)
    R_wb[:, 0, 0], R_wb[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    R_wb[:, 1, 0], R_wb[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    R_wb[:, 2, 2] = 1.0
    R_vi = np.transpose(R_wb, (0, 2, 1))
    pad0 = lambda a: np.concatenate([np.zeros_like(a[:1]), a], 0).astype(f32)  # noqa: E731
    fac = dict(dR=np.concatenate([np.eye(3, dtype=f32)[None],
                                  np.einsum("wji,wjk->wik", R_wb[:-1], R_wb[1:])], 0),
               dv=pad0(np.einsum("wji,wj->wi", R_wb[:-1], v[1:] - v[:-1] - G * dt)),
               dp=pad0(np.einsum("wji,wj->wi", R_wb[:-1],
                                 p[1:] - p[:-1] - v[:-1] * dt - 0.5 * G * dt * dt)),
               dt=np.concatenate([[0.0], np.full(W - 1, dt)]).astype(f32),
               valid=np.concatenate([[False], np.ones(W - 1, bool)]))
    s = 0.8
    vi = dict(R=R_vi, t=-np.einsum("wij,wj->wi", R_vi, p[0] + s * (p - p[0])).astype(f32),
              X=(p[0] + s * (X - p[0])).astype(f32),
              obs=project(R_vi, -np.einsum("wij,wj->wi", R_vi, p)), mask=mask, **intr)
    return vision, vi, (s * v).astype(f32), fac, G


def _par_solvers(vision, vi, v0, fac, G, dev, mesh=None):
    """name -> a function running that LM (PAR_ITERS iterations) on `dev`:
    the distributed one on this rank's shard of `mesh`, else the one-process
    bundle_adjust / vi_bundle_adjust (with the distributed form's bias prior
    weights). Each returns (R, t, X, v, bg, ba, final cost, initial cost)
    on the device (v, bg, ba None where the LM has none)."""
    from vislam_tpu_torch.backend.ba import BAProblem, BAState, bundle_adjust
    from vislam_tpu_torch.backend.vi_ba import ImuFactors, vi_bundle_adjust
    from vislam_tpu_torch.parallel.dist_ba import (
        dist_bundle_adjust, dist_vi_bundle_adjust, shard_problem,
    )

    def problem(q):
        st = BAState(*[torch.from_numpy(q[k]).to(dev) for k in ("R", "t", "X")])
        pr = BAProblem(torch.from_numpy(q["obs"]).to(dev), torch.from_numpy(q["mask"]).to(dev),
                       q["fx"], q["fy"], q["cx"], q["cy"])
        return shard_problem(st, pr, mesh) if mesh is not None else (st, pr)

    W = PAR_W
    zJ, z3 = np.zeros((W, 3, 3), np.float32), np.zeros((W, 3), np.float32)
    facs = {"vi": fac, "vi_bias": dict(fac, J_R_bg=zJ, J_v_bg=zJ, J_v_ba=zJ, J_p_bg=zJ,
                                       J_p_ba=zJ, bg_ref=z3, ba_ref=z3)}
    facs = {k: ImuFactors(**{n: torch.from_numpy(x).to(dev) for n, x in f.items()})
            for k, f in facs.items()}
    v, g, eye = (torch.from_numpy(x).to(dev) for x in (v0, G, np.eye(3, dtype=np.float32)))
    zero = torch.zeros(3, device=dev)
    bias = dict(bg0=zero, ba0=zero, w_bg_prior=1e4, w_ba_prior=3e3)
    vis, vip = problem(vision), problem(vi)

    def out(st, info, vel=None, bg=None, ba=None):
        return (st.R, st.t, st.X, vel, bg, ba, info["final_cost"], info["initial_cost"])

    if mesh is not None:
        return {
            "vision": lambda: out(*dist_bundle_adjust(*vis, mesh, iters=PAR_ITERS)),
            "vi": lambda: (lambda r: out(r[0][0], r[1], r[0][1]))(dist_vi_bundle_adjust(
                *vip, v, facs["vi"], g, eye, mesh, iters=PAR_ITERS)),
            "vi_bias": lambda: (lambda r: out(r[0][0], r[1], *r[0][1:]))(dist_vi_bundle_adjust(
                *vip, v, facs["vi_bias"], g, eye, mesh, iters=PAR_ITERS, **bias)),
        }
    return {
        "vision": lambda: out(*bundle_adjust(*vis, iters=PAR_ITERS)),
        "vi": lambda: (lambda r: out(r[0][0], r[1], r[0][1]))(vi_bundle_adjust(
            *vip, v, facs["vi"], g, eye, iters=PAR_ITERS)),
        "vi_bias": lambda: (lambda r: out(r[0][0], r[1], *r[0][1:]))(vi_bundle_adjust(
            *vip, v, facs["vi_bias"], g, eye, iters=PAR_ITERS, **bias)),
    }


def _host(result) -> dict:
    names = ("R", "t", "X", "v", "bg", "ba", "final_cost", "initial_cost")
    return {k: None if x is None else x.cpu().numpy() for k, x in zip(names, result)}


def _all_syncs(fn) -> tuple:
    """(the syncs _host_syncs finds in fn, the count of sync warnings that
    native code wrote to stderr meanwhile): gloo stages a CUDA tensor
    through the host on a thread of its own, whose warnings under sync
    debug mode bypass Python's warnings."""
    import tempfile

    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 2)
        try:
            py = _host_syncs(fn)
            torch.cuda.synchronize()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        return py, f.read().decode(errors="replace").count("called a synchronizing CUDA")


def _par_lm_rank(dev_type: str, with_single: bool) -> dict:
    """In each rank of a pool on the card: the three distributed LMs on the
    dryrun's problems at L = 512 x ranks, each once to warm up, once timed
    (ms per LM iteration, synchronised) and once under sync debug mode (the
    host syncs inside, Python's and native code's); with_single, also the
    one-process solve of the same
    problem on this card and the largest difference from it."""
    import torch.distributed as dist

    from vislam_tpu_torch.parallel.mesh import axis_position, make_mesh, mesh_device

    mesh = make_mesh(device_type=dev_type)
    dev = mesh_device(mesh)
    problems = _dryrun_problems(dist.get_world_size())
    dist_fns = _par_solvers(*problems, dev, mesh)
    single = _par_solvers(*problems, dev) if with_single else {}
    out = {}
    for name, fn in dist_fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _host(fn())
        ms = (time.perf_counter() - t0) * 1e3 / PAR_ITERS
        syncs, native = _all_syncs(fn)
        out[name] = dict(res, ms=ms, syncs=len(syncs) + native, sites=sorted(set(syncs)),
                         native=native, index=axis_position(mesh, "map")[0])
        if with_single:
            one = _host(single[name]())
            out[name]["single_err"] = max(float(np.abs(res[k] - one[k]).max())
                                          for k in res if res[k] is not None)
    return out


def _par_lm_check(pool1, pool4) -> None:
    """a. The three distributed LMs: 1 rank under NCCL equal to the one-process
    solve on the card (1e-5) with 0 host syncs; 4 ranks under gloo against the
    one-process solve of the 4-rank problem at tests/test_parallel.py's
    tolerances."""
    one = pool1.run(_par_lm_rank, DEV, True)[0]
    for name in _PAR_LMS:
        r = one[name]
        print(f"parallel a: {name}, 1 rank ({pool1.backend}), W {PAR_W}, L {PAR_L}: "
              f"{r['ms']:.2f} ms per LM iteration, cost {float(r['initial_cost']):.6g} -> "
              f"{float(r['final_cost']):.6g}, max |dist - one process| {r['single_err']:.3e}, "
              f"host syncs {r['syncs']} {r['sites']} (native {r['native']})", flush=True)
        if not r["single_err"] <= 1e-5 or r["syncs"]:
            _fail(f"parallel a: {name} on one NCCL rank differs from the one-process solve "
                  f"or syncs the host")
    vision, vi, v0, fac, G = _dryrun_problems(PAR_RANKS)
    want = {k: _host(fn()) for k, fn in _par_solvers(vision, vi, v0, fac, G, DEV).items()}
    four = pool4.run(_par_lm_rank, DEV, False)
    for name in _PAR_LMS:
        w, ranks = want[name], sorted((r[name] for r in four), key=lambda r: r["index"])
        # tests/test_parallel.py's tolerances (VI: t 2e-3; the online bias: v 1e-2).
        tols = {"R": 1e-4, "t": 1e-3 if name == "vision" else 2e-3, "X": 5e-3,
                "v": 1e-2 if name == "vi_bias" else 2e-3, "bg": 1e-3, "ba": 1e-2}
        err = {k: max(float(np.abs((np.concatenate([r["X"] for r in ranks])
                                    if k == "X" else r[k]) - w[k]).max()) for r in ranks)
               for k in tols if w[k] is not None}
        # rtol 1e-3; the noise-free vision window ends near 5e-7, below the
        # float32 round-off of its 20480 residuals' squares (~2e-5): atol 1e-5.
        dcost = max(abs(float(r["final_cost"]) - float(w["final_cost"])) for r in ranks)
        cost_rel = dcost / abs(float(w["final_cost"]))
        print(f"parallel a: {name}, {PAR_RANKS} ranks ({pool4.backend}), W {PAR_W}, L "
              f"{PAR_L * PAR_RANKS}: {max(r['ms'] for r in ranks):.2f} ms per LM iteration "
              f"(slowest rank), host syncs per LM per rank {ranks[0]['syncs']} (native "
              f"{ranks[0]['native']}: gloo's {3 * PAR_ITERS + 1} collectives, each staged "
              f"through the host); against one process: "
              f"final cost {float(w['final_cost']):.6g}, |d| {dcost:.2e} (rel {cost_rel:.2e}), "
              + ", ".join(f"{k} {e:.2e}" for k, e in err.items()), flush=True)
        if dcost > 1e-3 * abs(float(w["final_cost"])) + 1e-5 \
                or any(e > tols[k] for k, e in err.items()):
            _fail(f"parallel a: {name} on {PAR_RANKS} gloo ranks disagrees with one process")


def _par_cli_check(pool1) -> None:
    """b. The CLI on EVAL config 2's sequence with --dist-ba 4: the mesh line,
    accepted, every rank's launches (one batched window match), the refined
    keyframe rows against a one-rank refine of the same window, the ATE."""
    import tempfile

    from vislam_tpu_torch.parallel.mesh import refine_window_rank

    with tempfile.TemporaryDirectory() as tmp:
        rep, text = _main_printing(
            ["--synthetic", str(PAR_CLI_FRAMES), "--imu-scale", "--vi-ba", "--dist-ba",
             str(PAR_RANKS), "--output", os.path.join(tmp, "t.csv")], "parallel b")
    d = rep["dist_ba"]
    if f"distributed window BA (mesh={PAR_RANKS} devices)" not in text \
            or not d["info"]["accepted"]:
        _fail("parallel b: no accepted distributed window BA line")
    for r, launches in enumerate(d["launches"]):
        got = {k: n for k, n in launches.items() if n}
        if got != _PAR_REFINE:
            _fail(f"parallel b: rank {r} launched {got}, expected {_PAR_REFINE}")
    new, info, launches1 = pool1.run(refine_window_rank, *d["handed"], DEV)[0]
    count = int(new.window.count)
    kf_rows = [r for r in rep["rows"] if r["is_kf"]]
    n_back = min(count, len(kf_rows))
    one = -torch.einsum("wji,wj->wi", new.window.R_cw, new.window.t_cw).numpy()
    got = np.array([r["est_p"] for r in kf_rows[len(kf_rows) - n_back:]])
    dp = float(np.abs(got - one[count - n_back:count]).max())
    print(f"parallel b: {PAR_RANKS} ranks ({d['backend']} on {', '.join(d['devices'])}): cost "
          f"{float(d['info']['initial_cost']):.4f} -> {float(d['info']['final_cost']):.4f}; "
          f"launches per rank {_PAR_REFINE}; 1 rank ({pool1.backend}): cost "
          f"{float(info['initial_cost']):.4f} -> {float(info['final_cost']):.4f}, the "
          f"{n_back} refined keyframe rows within {dp:.3e} m of it; ATE {rep['ate']:.4f} m "
          f"over frames 1-{PAR_CLI_FRAMES - 1} (printed, not bounded)", flush=True)
    if not dp <= 1e-2 or not info["accepted"] or \
            {k: n for k, n in launches1.items() if n} != _PAR_REFINE:
        _fail("parallel b: the 4-rank refine disagrees with the 1-rank refine")


def _par_batch_rank(dev_type: str, B: int, N: int) -> dict:
    """In each rank: its own slice of B synthetic sequences (seeds 0 to
    B - 1, made and staged here), run_batch_sharded over N frames with the
    launches counted, then the same run timed between barriers, and the
    gathered batch."""
    import torch.distributed as dist

    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine import (
        VIOEngine, make_batch_inputs, make_sequence_inputs, stack_states,
    )
    from vislam_tpu_torch.parallel.batch_runner import gather_batch, run_batch_sharded
    from vislam_tpu_torch.parallel.mesh import axis_position, make_mesh, process_shard_range

    mesh = make_mesh(axis_names=("seq",), device_type=dev_type)
    lo, hi = process_shard_range(B, *axis_position(mesh, "seq"))
    seqs = [make_synthetic_sequence(SyntheticConfig(n_frames=N + 1, n_landmarks=300, seed=s))
            for s in range(lo, hi)]
    eng = VIOEngine(seqs[0]["calib"], device=dev_type)
    states = stack_states([eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0],
                                          v_w0=s["gt_vel"][0], p_w0=s["gt_pos"][0])
                           for s in seqs])
    inputs = make_batch_inputs([make_sequence_inputs(s, device=dev_type) for s in seqs])
    kf0 = np.stack([s["gt_pos"][0] for s in seqs]).astype(np.float32)

    def run():
        return run_batch_sharded(eng, states, inputs, kf0, mesh, process_local=True)

    reset_launches()
    _, res = run()
    torch.cuda.synchronize()
    launches = read_launches()
    dist.barrier()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    dist.barrier()
    wall = time.perf_counter() - t0
    res = gather_batch(res, mesh)
    return dict(p=res.p_wc.cpu().numpy(), kf=res.is_keyframe.cpu().numpy(), launches=launches,
                wall=wall, span=(lo, hi))


def _par_batch_check(pool4) -> None:
    """c. run_batch_sharded: 4 ranks x 2 of batch8's configuration against
    run_batch_scan of the 8 in this process (keyframes equal, positions
    within 1e-3 m), exact launches per batched step in every rank, and the
    aggregate frames/s of both."""
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.engine import (
        VIOEngine, make_batch_inputs, make_sequence_inputs, run_batch_scan, stack_states,
    )

    B, N = PAR_BATCH
    seqs = [make_synthetic_sequence(SyntheticConfig(n_frames=N + 1, n_landmarks=300, seed=s))
            for s in range(B)]
    eng = VIOEngine(seqs[0]["calib"], device=DEV)
    states = stack_states([eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0],
                                          v_w0=s["gt_vel"][0], p_w0=s["gt_pos"][0])
                           for s in seqs])
    inputs = make_batch_inputs([make_sequence_inputs(s, device=DEV) for s in seqs])
    kf0 = np.stack([s["gt_pos"][0] for s in seqs]).astype(np.float32)
    _, res = run_batch_scan(eng, states, inputs, kf0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_batch_scan(eng, states, inputs, kf0)
    torch.cuda.synchronize()
    one_fps = B * N / (time.perf_counter() - t0)
    ranks = pool4.run(_par_batch_rank, DEV, B, N)
    for r, got in enumerate(ranks):
        _launches_equal(f"parallel c: rank {r}", got["launches"], _BATCH_STEP, N)
    p, kf = ranks[0]["p"], ranks[0]["kf"]
    dp = float(np.abs(p - res.p_wc.cpu().numpy()).max())
    kf_eq = bool((kf == res.is_keyframe.cpu().numpy()).all())
    fps = B * N / ranks[0]["wall"]
    print(f"parallel c: run_batch_sharded, {pool4.backend}, {len(ranks)} ranks x "
          f"{B // len(ranks)} sequences ({[r['span'] for r in ranks]}) x {N} frames "
          f"(batch8 cut from 60 frames to {N}, to keep the run under three quarters of its "
          f"limit): {fps:.2f} frames/s aggregate, beside "
          f"{one_fps:.2f} for run_batch_scan of {B} in one process (the same call; printed, "
          f"not bounded); launches per batched step in every rank {_BATCH_STEP}; against "
          f"one process: keyframes "
          f"equal {kf_eq}, max |dp_wc| {dp:.3e} m", flush=True)
    if not kf_eq or not dp <= 1e-3:
        _fail("parallel c: the sharded batch disagrees with the one-process batch")


def parallel_phase() -> None:
    """The distributed paths (`parallel/`) on the one card: a pool of 1 rank
    (NCCL) and one of 4 (gloo, sharing the card), each started once (the
    kernels are built already), and the CLI's own 4 ranks."""
    from vislam_tpu_torch.parallel.mesh import Ranks

    t0 = time.perf_counter()
    with Ranks(1, device=DEV) as pool1, Ranks(PAR_RANKS, device=DEV) as pool4:
        print(f"parallel: pools {pool1.describe()}; {pool4.describe()} "
              f"(started in {time.perf_counter() - t0:.1f} s)", flush=True)
        if DEV == "cuda" and (pool1.backend, pool4.backend) != ("nccl", "gloo"):
            _fail("parallel: expected NCCL for one rank and gloo for ranks sharing the card")
        t0 = time.perf_counter()
        _par_lm_check(pool1, pool4)
        _phase("parallel a (distributed LM)", t0)
        t0 = time.perf_counter()
        _par_cli_check(pool1)
        _phase("parallel b (cli --dist-ba)", t0)
        t0 = time.perf_counter()
        _par_batch_check(pool4)
        _phase("parallel c (run_batch_sharded)", t0)


# ----------------------------------------------------------------- phase eval
EVAL_MATCH_FRAMES = 6
EVAL_REGIMES = ("natural", "repetitive")
# Three of scripts/eval_matchability.py's frontend rows: frontend overrides,
# the gate (px), the launches per frame (both levels' response) and per
# pair (the match), and MATCHABILITY.md's inlier rates on natural and
# repetitive (16 frames at 752x480, the JAX package's frontend).
EVAL_FRONTENDS = {
    "shi_tomasi+sift (default)": ({}, 0.0, {"shi_tomasi": 2},
                                  {"match_top2": 1, "match_top2_per_pair": 1}, (0.992, 0.745)),
    "dog+sift guided(30px)": (dict(detector="dog"), 30.0, {"dog": 2},
                              {"match_top2": 1, "match_top2_per_pair": 1,
                               "match_top2_gated": 1}, (0.976, 0.838)),
    "fast+brief (AKAZE-ish)": (dict(detector="fast", descriptor="brief"), 0.0, {"fast": 2},
                               {"match_top2": 1, "match_top2_per_pair": 1}, (0.997, 0.879)),
}
EVAL_RUNNER_FRAMES = 20


def _pairs_agree(a_pairs, b_pairs, tol=1e-2) -> tuple:
    """(matches, matches of either side without a twin within tol px)."""
    total, lone = 0, 0
    for a, b in zip(a_pairs, b_pairs):
        x = np.concatenate([a["uv_a"], a["uv_b"]], -1)
        y = np.concatenate([b["uv_a"], b["uv_b"]], -1)
        total += max(len(x), len(y))
        if len(x) == 0 or len(y) == 0:
            lone += len(x) + len(y)
            continue
        d = np.abs(x[:, None, :] - y[None, :, :]).max(-1)
        lone += int((d.min(1) >= tol).sum() + (d.min(0) >= tol).sum())
    return total, lone


def _eval_match_check() -> None:
    from vislam_tpu_torch.data.adversarial import make_adversarial_sequence, presets
    from vislam_tpu_torch.eval.matchability import repo_match_pairs, score_pairs
    from vislam_tpu_torch.utils.config import FrontendConfig

    n, pairs = EVAL_MATCH_FRAMES, EVAL_MATCH_FRAMES - 1
    for r, regime in enumerate(EVAL_REGIMES):
        t0 = time.perf_counter()
        seq = make_adversarial_sequence(dataclasses.replace(presets()[regime], n_frames=n))
        H, W = seq["images"][0].shape
        print(f"eval a: {regime}, {n} frames {W}x{H} rendered in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, (over, gate, per_frame, per_pair, rates) in EVAL_FRONTENDS.items():
            fcfg = FrontendConfig(**over)
            repo_match_pairs(seq, fcfg, gate_px=gate, device=DEV)   # first use: loads, allocs
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            card = repo_match_pairs(seq, fcfg, gate_px=gate, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            expected = {k: v * n for k, v in per_frame.items()}
            for k, v in per_pair.items():
                expected[k] = expected.get(k, 0) + v * pairs
            for counter, got in launches.items():
                if got != expected.get(counter, 0):
                    _fail(f"eval {regime} {name}: {counter} launched {got} times over {n} frames "
                          f"and {pairs} pairs (expected {expected.get(counter, 0)})")
            cpu = repo_match_pairs(seq, fcfg, gate_px=gate, device="cpu")
            total, lone = _pairs_agree(card, cpu)
            s_card = score_pairs(seq["scene"], card, name=name)
            s_cpu = score_pairs(seq["scene"], cpu, name=name)
            print(f"eval a: {regime} {name}: {wall * 1e3:.1f} ms for {n} frames and {pairs} "
                  f"pairs; launches {_nonzero(launches)} (exact); card vs CPU: {total} matches, "
                  f"{lone} without a twin within 1e-2 px; matches/pair {s_card.matches_per_pair:.1f}"
                  f" (CPU {s_cpu.matches_per_pair:.1f}), inlier rate "
                  f"{100 * s_card.inlier_rate:.1f}% (CPU {100 * s_cpu.inlier_rate:.1f}%; "
                  f"MATCHABILITY.md, 16 frames: {100 * rates[r]:.1f}%), px err "
                  f"{s_card.mean_px_err:.2f}", flush=True)
            if lone > 0.01 * total:
                _fail(f"eval {regime} {name}: the card's matches differ from the CPU's "
                      f"({lone} of {total} without a twin)")
            if regime == "natural" and not s_card.inlier_rate > 0.9:
                _fail(f"eval natural {name}: inlier rate {s_card.inlier_rate:.3f} <= 0.9")


def _eval_runner_check(seq) -> None:
    from vislam_tpu_torch.eval import run_vio_sequence

    n = EVAL_RUNNER_FRAMES + 1
    run_vio_sequence(seq, n_frames=3, device=DEV)    # first use
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card = run_vio_sequence(seq, n_frames=n, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    # initialize's two levels, then each frame's (_VARIANT_STEP: the default step).
    expected = {k: v * (n - 1) for k, v in _VARIANT_STEP.items()}
    expected["shi_tomasi"] += 2
    for counter, got in launches.items():
        if got != expected.get(counter, 0):
            _fail(f"eval run_vio_sequence: {counter} launched {got} times over {n - 1} frames "
                  f"(expected {expected.get(counter, 0)})")

    # The CPU run at the same seed: the card's draws, made by the CPU's twin.
    cpu = run_vio_sequence(seq, n_frames=n, device="cpu")
    dp = float(np.abs(card["poses"] - cpu["poses"]).max())
    print(f"eval b: run_vio_sequence, {n - 1} frames GT scale, {wall:.2f} s on the card "
          f"({(n - 1) / wall:.2f} frames/s with its per-frame fetch); launches "
          f"{_nonzero(launches)} (exact); ATE {card['ate']:.4f} m (CPU {cpu['ate']:.4f}); "
          f"card vs CPU at one seed (the same draws): max |dp| {dp:.3e} m (tolerance 1e-2)",
          flush=True)
    if not (np.isfinite(card["poses"]).all() and dp <= 1e-2 and card["ate"] < 0.5):
        _fail("eval run_vio_sequence: the card's run disagrees with the CPU's or ATE >= 0.5 m")


def eval_phase(seq) -> None:
    """The evaluation layer on the card: a. matchability; b. the runner."""
    t0 = time.perf_counter()
    _eval_match_check()
    _phase("eval a (matchability)", t0)
    t0 = time.perf_counter()
    _eval_runner_check(seq)
    _phase("eval b (run_vio_sequence)", t0)


# ------------------------------------------------------------------ phase api
# Card vs CPU on the whole IMU stream (S samples): the tests' float32 bounds
# at S = 200 (tests/test_torch_api_functions.py: 2e-6 on unit quaternions,
# 1e-5 on v and p), grown linearly with S as round-off carried by the state.
API_TOL_PER_200 = (2e-6, 1e-5)
API_WINDOW = 100          # dead_reckon / predict_state against GT: 0.5 s windows
API_WINDOW_FRAMES = (0, 20, 40)   # their first frames
API_GT_TOL = (0.01, 0.02)   # m, m/s (tests/test_inertial.py)
API_TILT = (0.2, -0.3)    # roll, pitch of the static tilt case (rad; tolerance 1e-5)
API_PAIR = (0, 2)         # the default path's frame pair for the epipolar mask
API_EPI_THRESH = 0.02     # BackendConfig.ransac_thresh


def _api_filters(seq) -> None:
    from vislam_tpu_torch import lie
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.inertial import (complementary_scan, dead_reckon,
                                           orientation_from_accel, preintegrate)
    from vislam_tpu_torch.inertial.preintegration import predict_state

    def f32(x, dev):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    def run(dev):
        g, a = f32(seq["imu_gyro"], dev), f32(seq["imu_accel"], dev)
        dt = torch.full((g.shape[0],), 1.0 / 200.0, device=dev)
        q0, v0, p0 = (f32(seq[k][0], dev) for k in ("gt_quat", "gt_vel", "gt_pos"))
        out = {"tilt": orientation_from_accel(a), "comp": complementary_scan(q0, g, a, dt)[1]}
        out["q"], out["v"], out["p"], out["ps"] = dead_reckon(q0, v0, p0, g, a, dt)
        return {k: v.cpu() for k, v in out.items()}

    S = len(seq["imu_gyro"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run(DEV)
    wall = time.perf_counter() - t0
    cpu = run("cpu")
    q_tol, vp_tol = (t * S / 200 for t in API_TOL_PER_200)
    tols = {"tilt": q_tol, "comp": q_tol, "q": q_tol, "v": vp_tol, "p": vp_tol, "ps": vp_tol}
    errs = {k: float((card[k] - cpu[k]).abs().max()) for k in tols}
    print(f"api: orientation_from_accel, complementary_scan, dead_reckon over the default "
          f"path's IMU stream ({S} samples) in {wall:.2f} s on the card (a Python loop of "
          f"~40 launches per sample); card vs CPU max |d| "
          + ", ".join(f"{k} {errs[k]:.2e} (tolerance {tols[k]:.1e})" for k in tols), flush=True)
    bad = [k for k in tols if not (torch.isfinite(card[k]).all() and errs[k] <= tols[k])]
    if bad:
        _fail(f"api: the card's {bad} disagree with the CPU's")
    # The default path's motion drags an accelerometer tilt (specific force
    # up to ~3 m/s^2 off gravity): its error against GT is printed, the
    # filters are held to GT on the tests' cases below.
    idx = np.arange(10, S, 10)
    gt_rpy = lie.quat_to_rpy(f32(seq["gt_quat"][1:len(idx) + 1], "cpu"))
    comp_err = float((lie.quat_to_rpy(card["comp"][idx - 1]) - gt_rpy)[:, :2].abs().max())
    drift = float((card["ps"][idx - 1] - f32(seq["gt_pos"][1:len(idx) + 1], "cpu")).abs().max())
    print(f"api: on the default path's motion, complementary_scan's roll/pitch within "
          f"{comp_err:.3f} rad of GT, dead_reckon over {S / 200:.1f} s within {drift:.4f} m "
          f"(printed, not bounded)", flush=True)

    # tests/test_inertial.py's cases on the card: a static tilt, the
    # complementary filter on its gentle sequence (seed 7), dead_reckon
    # and predict_state over 0.5 s windows of the default path's stream.
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler("ZYX", [0.0, API_TILT[1], API_TILT[0]]).as_matrix()
    rpy = lie.quat_to_rpy(orientation_from_accel(f32(R.T @ [0.0, 0.0, 9.81], DEV))).cpu()
    tilt_err = float((rpy[:2] - torch.tensor(API_TILT)).abs().max())
    gentle = make_synthetic_sequence(SyntheticConfig(n_frames=60, n_landmarks=10, seed=7,
                                                     trans_amp=(0.08, 0.05, 0.03)))
    n = len(gentle["imu_gyro"])
    qf, _ = complementary_scan(f32(gentle["gt_quat"][0], DEV), f32(gentle["imu_gyro"], DEV),
                               f32(gentle["imu_accel"], DEV),
                               torch.full((n,), 1.0 / 200.0, device=DEV), alpha=0.01)
    gentle_err = float((lie.quat_to_rpy(qf.cpu())
                        - lie.quat_to_rpy(f32(gentle["gt_quat"][-1], "cpu"))).abs().max())
    dt = torch.full((API_WINDOW,), 1.0 / 200.0, device=DEV)
    win = []
    for f in API_WINDOW_FRAMES:
        lo, j = f * 10, f + API_WINDOW // 10
        g, a = f32(seq["imu_gyro"][lo:lo + API_WINDOW], DEV), f32(
            seq["imu_accel"][lo:lo + API_WINDOW], DEV)
        q0, v0, p0 = (f32(seq[k][f], DEV) for k in ("gt_quat", "gt_vel", "gt_pos"))
        _, v, p, _ = dead_reckon(q0, v0, p0, g, a, dt)
        _, v2, p2 = predict_state(preintegrate(g, a, dt), lie.quat_to_mat(q0), v0, p0)
        gt_p, gt_v = f32(seq["gt_pos"][j], "cpu"), f32(seq["gt_vel"][j], "cpu")
        win.append([float((x.cpu() - y).abs().max())
                    for x, y in ((p, gt_p), (v, gt_v), (p2, gt_p), (v2, gt_v))])
    win = np.max(win, axis=0)
    print(f"api: on the card, orientation_from_accel's static tilt within {tilt_err:.2e} rad "
          f"(tolerance 1e-5), complementary_scan on the gentle sequence (seed 7, {n} samples) "
          f"within {gentle_err:.4f} rad of GT roll/pitch/yaw (tolerance 0.05); over "
          f"windows of {API_WINDOW} samples from frames {API_WINDOW_FRAMES}, dead_reckon within "
          f"{win[0]:.4f} m, {win[1]:.4f} m/s and predict_state within {win[2]:.4f} m, "
          f"{win[3]:.4f} m/s of GT (tolerances {API_GT_TOL[0]} m, {API_GT_TOL[1]} m/s)",
          flush=True)
    if not (tilt_err <= 1e-5 and gentle_err <= 0.05 and win[0] <= API_GT_TOL[0]
            and win[1] <= API_GT_TOL[1] and win[2] <= API_GT_TOL[0]
            and win[3] <= API_GT_TOL[1]):
        _fail("api: a filter or the integrator misses GT on the card")


def _api_matches(seq) -> None:
    from vislam_tpu_torch import lie
    from vislam_tpu_torch.calib import unproject_pixels
    from vislam_tpu_torch.frontend import epipolar_inlier_mask, extract_features, match_descriptors
    from vislam_tpu_torch.frontend.match import gather_matched
    from vislam_tpu_torch.frontend.pose import epipolar_normals
    from vislam_tpu_torch.utils.config import FrontendConfig

    fe, cal = FrontendConfig(), seq["calib"]
    i, j = API_PAIR
    torch.cuda.synchronize()
    reset_launches()
    fa, fb = (extract_features(torch.as_tensor(seq["images"][k]).to(DEV, torch.float32), fe)
              for k in (i, j))
    matches = match_descriptors(fa.desc, fa.mask, fb.desc, fb.mask, ratio=fe.ratio_thresh,
                                mutual=fe.mutual_check)
    torch.cuda.synchronize()
    launches = read_launches()
    expected = {"shi_tomasi": 4, "match_top2": 1, "match_top2_per_pair": 1}
    for counter, got in launches.items():
        if got != expected.get(counter, 0):
            _fail(f"api: {counter} launched {got} times for two frames' features and their "
                  f"match (expected {expected.get(counter, 0)})")

    # GT relative pose of the camera: X_j = R_ji X_i + t, t_dir = t / |t|.
    T_bc = np.asarray(cal.T_body_cam, np.float64)
    Rc, pc = [], []
    for k in (i, j):
        R_wb = lie.quat_to_mat(torch.as_tensor(seq["gt_quat"][k], dtype=torch.float64)).numpy()
        Rc.append(R_wb @ T_bc[:3, :3])
        pc.append(seq["gt_pos"][k] + R_wb @ T_bc[:3, 3])
    R_ji = Rc[1].T @ Rc[0]
    t = Rc[1].T @ (pc[0] - pc[1])
    R_ji, t_dir = (torch.as_tensor(x, dtype=torch.float32) for x in (R_ji, t / np.linalg.norm(t)))

    def mask_on(dev):
        uv_a, uv_b, ok = gather_matched(fa.uv.to(dev), fb.uv.to(dev), _to_device(matches, dev))
        rays_i, rays_j = (unproject_pixels(uv, cal.fx, cal.fy, cal.cx, cal.cy)
                          for uv in (uv_a, uv_b))
        inl = epipolar_inlier_mask(rays_i, rays_j, R_ji.to(dev), t_dir.to(dev), API_EPI_THRESH)
        n, _ = epipolar_normals(rays_i, rays_j, R_ji.to(dev))
        return [x.cpu() for x in (uv_a, uv_b, ok, inl, (n @ t_dir.to(dev)).abs())]

    card, cpu = mask_on(DEV), mask_on("cpu")
    same_gather = all(torch.equal(x, y) for x, y in zip(card[:3], cpu[:3]))
    ok = card[2]
    clear = (cpu[4] - API_EPI_THRESH).abs() > 1e-5
    differ = int(((card[3] != cpu[3]) & clear).sum())

    def share(t):
        rays = [unproject_pixels(uv.to(DEV), cal.fx, cal.fy, cal.cx, cal.cy) for uv in card[:2]]
        inl = epipolar_inlier_mask(*rays, R_ji.to(DEV), t.to(DEV), API_EPI_THRESH).cpu()
        return float((inl & ok).sum()) / max(int(ok.sum()), 1)

    # The matches' inlier share on the GT direction, and on the three
    # directions perpendicular to it (t x each axis): a wrong direction
    # keeps few of them.
    gt_share = share(t_dir)
    wrong = [share(torch.linalg.cross(t_dir, e) / torch.linalg.cross(t_dir, e).norm())
             for e in torch.eye(3)]
    print(f"api: frames {i} and {j} of the default path: launches {_nonzero(launches)} (exact); "
          f"gather_matched on the card equal to the CPU's: {same_gather}; "
          f"epipolar_inlier_mask at {API_EPI_THRESH}: {differ} rows differing from the CPU's "
          f"away from the threshold ({int((~clear).sum())} within 1e-5 of it); inliers among "
          f"{int(ok.sum())} matches {gt_share:.3f} on the GT direction, "
          f"{', '.join(f'{w:.3f}' for w in wrong)} on the directions perpendicular to it "
          f"(bounds: > 0.5 and 5x each of those)", flush=True)
    if not (same_gather and differ == 0 and gt_share > 0.5 and 5 * max(wrong) < gt_share):
        _fail("api: the epipolar mask or the matched gather disagrees with the CPU or the GT")


def api_phase(seq) -> None:
    """The last of the public surface on the card, each against the CPU."""
    t0 = time.perf_counter()
    _api_filters(seq)
    _api_matches(seq)
    _phase("api", t0)


def _phase(name, t0) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    t_main = time.perf_counter()
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
    # An operator without a batching rule raises under vmap instead of
    # looping over the batch's entries one by one.
    torch._C._functorch._set_vmap_fallback_enabled(False)
    print("vmap per-example fallback disabled", flush=True)

    t0 = time.perf_counter()
    for name, path in zip(build.SOURCES, build.build_all(build.SOURCES)):
        print(f"build: {path}", flush=True)
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas_phase()

    t0 = time.perf_counter()
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=N_FRAMES + 1, n_landmarks=300,
                                                  seed=0))
    print(f"data: {N_FRAMES + 1} frames 480x752 in {time.perf_counter() - t0:.1f} s",
          flush=True)

    t0 = time.perf_counter()
    # The batched paths' sequences: seeds 0 to B - 1 (seed 0 is `seq`), each
    # as long as the longest path that steps it.
    seqs = [seq] + [make_synthetic_sequence(SyntheticConfig(
        n_frames=1 + max(bp.frames for bp in BATCH_PATHS.values() if bp.sequences > s),
        n_landmarks=300, seed=s)) for s in range(1, max(bp.sequences
                                                      for bp in BATCH_PATHS.values()))]
    print(f"data: {len(seqs)} sequences for the batched paths in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rows = kernel_phase(seq, seqs, SystemConfig())
    _phase("kernels", t0)
    t0 = time.perf_counter()
    rows += random_phase(seq, seqs, SystemConfig())
    _phase("random", t0)
    # Each row's launches come from the run of the path that uses it (the
    # D = 128 match from the default path, D = 256 from the akaze path).
    row_path = {"response_nms:shi_tomasi": "default", "response_nms:harris": "harris",
                "response_nms:dog": "dog", "response_nms:hessian": "kaze",
                "response_nms:fast": "akaze", "response_nms:_gradmag2": "kaze",
                "fed_evolve": "kaze", "match_top2:d128": "default",
                "match_top2:d256": "akaze", "match_top2:window": SLAM_PATH,
                "response_nms:shi_tomasi:batch8": "batch8", "match_top2:batch8_pairs": "batch8",
                "match_top2:batch8_window": "batch_slam", "fed_evolve:batch_kaze": "batch_kaze",
                "response_nms:_gradmag2:batch_kaze": "batch_kaze",
                "response_nms:hessian:batch_kaze": "batch_kaze",
                "response_nms:fast:batch_akaze": "batch_akaze",
                "match_top2:d256:batch_akaze": "batch_akaze",
                "threefry_categorical": "default",
                "threefry_categorical:essential": "batch_vision",
                "threefry_categorical:batch8": "batch8"}
    launches, profiled = {}, {}
    for name in PATHS:
        t0 = time.perf_counter()
        launches[name], ctx = path_phase(name, seq)
        if ctx is not None:
            profiled[name] = ctx
        _phase(f"path {name}", t0)
    t0 = time.perf_counter()
    refine_check(*profiled[SLAM_PATH][:2])
    _phase("refine check", t0)
    batched = {}
    for name in BATCH_PATHS:
        t0 = time.perf_counter()
        launches[name], batched[name] = batch_path_phase(name, seqs)
        _phase(f"path {name}", t0)
    t0 = time.perf_counter()
    cli_phase()
    _phase("cli", t0)
    t0 = time.perf_counter()
    map_phase()
    _phase("map", t0)
    t0 = time.perf_counter()
    variants, launches["batch_vision"] = variants_phase(seq, seqs)
    _phase("variants", t0)
    t0 = time.perf_counter()
    parallel_phase()
    _phase("parallel", t0)
    t0 = time.perf_counter()
    eval_phase(seq)
    _phase("eval", t0)
    api_phase(seq)
    # The order of what follows: see the module's docstring.
    t0 = time.perf_counter()
    for name, ctx in profiled.items():
        stage_times(name, *ctx)
    _phase("stage times", t0)
    t0 = time.perf_counter()
    timing_phase(rows)
    report_phase(rows)
    _phase("kernel times", t0)
    for name, ctx in profiled.items():
        t0 = time.perf_counter()
        trace_path(name, *ctx)
        _phase(f"trace {name}", t0)
    for name, ctx in batched.items():
        if not BATCH_PATHS[name].trace_steps:
            continue
        t0 = time.perf_counter()
        trace_batch_path(name, *ctx)
        _phase(f"trace {name}", t0)
    t0 = time.perf_counter()
    trace_variants(variants)
    _phase("trace variants", t0)
    for row in rows:
        row["launches"] = launches[row_path[row["name"]]][row["counter"]]

    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s in all", flush=True)
    print(_nvidia_smi(), flush=True)
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "graph_ms", "launches_per_call")},
         "bound_us": row["bound_ms"] * 1e3} for row in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

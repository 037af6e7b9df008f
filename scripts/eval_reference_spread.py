"""The JAX package's rows of EVAL configs 1, 2, 2c, 3, 4, 5 and 6 on the CPU, and their
spread under a 1-ulp change of the inputs or another RANSAC stream: the
reference values and bounds that `scripts/torch_eval_configs.py` holds the
port's card runs to.

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 1
        [--vary ulp|seed] [--seed 0] [--branch cpu|tpu] [--draws 4] [--first 0]
        [--out FILE]

Each config runs `scripts/eval_configs.py`'s own `run_vio` (configs 1, 2,
3 and 4, with the options its `main()` gives each row), `run_cold` (2c) or
`run_long` (6) on its pinned sequence (`PINNED`); config 5, inline in that
`main()`, is repeated by `run_batch` here. Each runs once as generated
(draw 0) and once per further draw d. With `--vary ulp` draw
d moves every IMU sample (gyro and accelerometer, float32) by one ulp up
or down at random (`numpy.random.default_rng(d)`); the images are not
perturbed, since the default pipeline runs them in bfloat16, where a
float32 ulp rounds away; every draw runs at RANSAC seed `--seed`. With
`--vary seed` draw d runs the engine with
RANSAC seed d (`VIOEngine(..., seed=d)`; config 5: `run_batch_scan(...,
seed=d)`): the port draws its hypotheses
from a stream of its own, so the reference's spread over streams is the
part of the difference the draws make. `--branch tpu` computes every
detector response in float32 from the bfloat16 pyramid, the arithmetic of
the reference's TPU branch (`frontend/detect.py`: the Pallas kernel takes
the level cast to float32), which the port implements; the default `cpu`
runs the reference's CPU branch (the response in the pyramid's bfloat16).
Prints each draw's row as it ends
and then one JSON object with every draw's row and, per metric, the
largest distance of a further draw from draw 0 (the spread).

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --ensemble
        [--configs 1,2,2c,3,4,5,6] [--jobs 8] [--part all|nofma] [--out FILE]

measures the reference's per-seed ensemble that the port's paired holds
take their bounds from: for each config and each RANSAC seed d
(`ENSEMBLE_SEEDS`: 0-7, config 6 seed 0) the TPU branch at seed d on the
inputs as generated (draw 0) and under each of the K = 4 one-ulp IMU
draws k = 1..4 (`--vary ulp --seed d`), each (config, seed) in a process
of its own (config 6: each draw), `--jobs` at a time; and draw 0 once
more, compiled without fused multiply-adds (`--nofma`: XLA's CPU compiler
held to the AVX instruction set, `--xla_cpu_max_isa=AVX`, which has no FMA
instructions), in a process of its own per (config, seed). XLA's default
CPU compile fuses the reference's products into FMAs wherever the host has
them; the no-FMA compile of the same program on the same inputs is the
reference's other legal outcome. Every process first checks its own
compile (`check_compile`). `--part nofma` runs only the no-FMA runs. Prints and writes one JSON object
{config: {metric: {"tpu": [8 draw-0 values], "ulp": [[4 perturbed values]
per seed], "spread": [max_k |ulp - tpu| per seed], "nofma": [8 values]}}},
the processes' seconds, the host (`host_isa`) and jax version, and the
table's lines for `REFERENCE` in `scripts/torch_eval_configs.py`.

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 3
        --locate ate_vi_online_ba_marg --branch tpu --seed d

locates where the port's trajectory behind one row (configs 1, 2, 3, 4:
`LOCATABLE`) parts from the reference's at RANSAC seed d (both draw the
same hypotheses since the port copies JAX's stream): the reference's run,
its runs under the K = 4 one-ulp IMU draws and the port's run on the CPU
(`scripts/torch_eval_configs.py`'s runner), frame by frame: the first
frame where each parts from the reference by more than 1e-6 m and by more
than 1e-4 m, the largest gap, each ATE, and whether the port parts earlier
than every one of the reference's own draws. `--config 4 --locate
correction` runs both packages' loop correction on the port's keyframe
archive (`locate_correction`).

    JAX_PLATFORMS=cpu python scripts/eval_reference_spread.py --config 3
        --lockstep ate_plain --branch tpu --seed d [--frames 20]

steps the port from the reference's state at every frame (`lockstep`):
what one step of the port changes, apart from what earlier steps
accumulated.
"""

from __future__ import annotations

import argparse
import functools
from concurrent.futures import ThreadPoolExecutor
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# config: (SyntheticConfig arguments, the row's metrics); config 5 steps
# eight sequences, seeds 0-7 (its "seed" is replaced by each)
CONFIGS = {
    "1": (dict(n_frames=80, n_landmarks=300, seed=0), ("ate",)),
    "2": (dict(n_frames=80, n_landmarks=300, seed=0),
          ("ate", "scale_ratio", "ate_vi_ba", "scale_ratio_vi_ba", "ate_open_unsupervised")),
    "2c": (dict(n_frames=60, n_landmarks=300, seed=0), ("ate_live", "ate_smoothed")),
    "3": (dict(n_frames=60, n_landmarks=350, seed=1, trans_amp=(2.0, 1.4, 0.7),
               rot_amp=(0.12, 0.15, 0.3)),
          ("ate_plain", "ate_photometric", "ate_online_ba", "ate_vi_open_loop",
           "ate_vi_online_ba_ends", "ate_vi_online_ba_marg")),
    "4": (dict(n_frames=86, n_landmarks=300, seed=21),
          ("ate_open_loop", "n_loops", "kf_maxerr_before", "kf_maxerr_after")),
    "5": (dict(n_frames=24, n_landmarks=250, seed=0), ("ate_mean", "ate_max")),
    "6": (dict(n_frames=500, n_landmarks=400, seed=42),
          ("ate_full", "ate_f1_100", "ate_f100_300", "ate_f300_500", "kf_maxerr_before",
           "kf_maxerr_after")),
}

# The ensemble's RANSAC seeds per config and its one-ulp draws per seed.
ENSEMBLE_SEEDS = {c: range(1) if c == "6" else range(8) for c in CONFIGS}
ULP_DRAWS = 4


NOFMA_FLAG = "--xla_cpu_max_isa=AVX"


def host_isa() -> dict:
    """The host's CPU model and the flags of /proc/cpuinfo that decide
    XLA's CPU compile of a multiply-add (fma, avx2, avx512f)."""
    model, flags = "unknown", set()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() == "model name" and model == "unknown":
                    model = value.strip()
                elif key.strip() == "flags" and not flags:
                    flags = set(value.split())
    except OSError:
        pass
    return {"model": model, **{f: f in flags for f in ("fma", "avx2", "avx512f")}}


def probe_inputs():
    """Fixed float32 a, b, c of `triangulate_midpoint`'s det = a c - b^2 for
    256 near-parallel ray pairs (points 8-21 m away, an 8 cm baseline), on
    which one product rounded or kept exact changes every det."""
    rng = np.random.default_rng(0)
    p = np.stack([rng.uniform(-6, 6, 256), rng.uniform(-4, 4, 256), rng.uniform(8, 21, 256)], -1)
    q = p - np.array([0.08, 0.02, 0.03])
    ri = (p / p[:, 2:3]).astype(np.float32)
    rj = (q / q[:, 2:3]).astype(np.float32)
    a = np.sum(ri.astype(np.float64) ** 2, -1).astype(np.float32)
    b = (-np.sum(ri.astype(np.float64) * rj, -1)).astype(np.float32)
    c = np.sum(rj.astype(np.float64) ** 2, -1).astype(np.float32)
    return a, b, c


def compile_probe() -> str:
    """How this process's XLA compiles `a * c - b * b` under `jax.jit` on
    `probe_inputs()`: "fused" where every det equals fma(a, c, -(b b)) (a c
    kept exact: float64 products, rounded once), "two-rounding" where every
    det equals numpy's float32 a c - b b (each product rounded), else
    "neither"."""
    import jax

    a, b, c = probe_inputs()
    got = np.asarray(jax.jit(lambda a, b, c: a * c - b * b)(a, b, c))
    two = a * c - b * b
    fused = (a.astype(np.float64) * c - (b * b).astype(np.float64)).astype(np.float32)
    assert not np.array_equal(two, fused)
    if np.array_equal(got, fused):
        return "fused"
    return "two-rounding" if np.array_equal(got, two) else "neither"


def check_compile(nofma: bool) -> str:
    """The probe's form, which must be "two-rounding" in a no-FMA process
    (or on a host without FMA) and "fused" otherwise; exits saying why if
    not."""
    want = "fused" if host_isa()["fma"] and not nofma else "two-rounding"
    got = compile_probe()
    if got != want:
        sys.exit(f"compile probe: a * c - b * b compiled {got}, expected {want} "
                 f"({'no-FMA' if nofma else 'default'} process, XLA_FLAGS="
                 f"{os.environ.get('XLA_FLAGS', '')!r}, host {host_isa()})")
    return got


def perturbed(seq, draw: int):
    """seq with its IMU samples moved by one float32 ulp (draw > 0)."""
    if draw == 0:
        return seq
    rng = np.random.default_rng(draw)
    out = dict(seq)
    for k in ("imu_gyro", "imu_accel"):
        x = np.asarray(seq[k], np.float32)
        away = np.where(rng.random(x.shape) < 0.5, np.float32(-np.inf), np.float32(np.inf))
        out[k] = np.nextafter(x, away.astype(np.float32))
    return out


def seeded(seed: int):
    """The reference's VIOEngine made with RANSAC seed `seed` wherever the
    harness makes one (it imports the class at call time)."""
    import vislam_tpu.engine as je

    je.VIOEngine = functools.partial(getattr(je.VIOEngine, "func", je.VIOEngine), seed=seed)


def tpu_branch():
    """Every detector response of the reference computed in float32 from
    its (bfloat16) pyramid level, as its TPU branch's kernel computes it."""
    import jax.numpy as jnp

    import vislam_tpu.frontend.detect as jd

    for name, fn in list(jd.DETECTOR_RESPONSES.items()):
        jd.DETECTOR_RESPONSES[name] = functools.partial(
            lambda img, fn: fn(img.astype(jnp.float32)), fn=fn)


def _path_length(p) -> float:
    return float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum())


def _with(**sections):
    """SystemConfig() with the given sections' fields replaced."""
    import dataclasses

    from vislam_tpu.utils.config import SystemConfig

    c = SystemConfig()
    return dataclasses.replace(c, **{k: dataclasses.replace(getattr(c, k), **v)
                                     for k, v in sections.items()})


def run_batch(seqs, seed: int = 0, cfg=None) -> dict:
    """Config 5 as `scripts/eval_configs.py`'s main() runs it: run_batch_scan
    over the sequences from their true initial states (cfg: the engine's,
    SystemConfig() by default), ATE per entry."""
    import jax
    import jax.numpy as jnp

    from vislam_tpu.engine import VIOEngine, make_sequence_inputs, run_batch_scan
    from vislam_tpu.eval import ate_rmse
    from vislam_tpu.utils.config import SystemConfig

    n = len(seqs[0]["images"])
    eng = VIOEngine(seqs[0]["calib"], cfg or SystemConfig())
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        eng.initialize(s["images"][0], q_wb0=s["gt_quat"][0], v_w0=s["gt_vel"][0],
                       p_w0=s["gt_pos"][0]) for s in seqs])
    inps = [make_sequence_inputs(s) for s in seqs]
    inputs = jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *inps)
    kf0 = jnp.stack([jnp.asarray(s["gt_pos"][0], jnp.float32) for s in seqs])
    _, res = run_batch_scan(eng, states, inputs, kf0, seed=seed)
    ates = [float(ate_rmse(np.asarray(res.p_wc[b]), s["gt_pos"][1:n], align=False))
            for b, s in enumerate(seqs)]
    return {"ate_mean": float(np.mean(ates)), "ate_max": float(np.max(ates)), "ates": ates,
            "poses": np.asarray(res.p_wc)}


def run_config(name: str, seq, seed: int = 0) -> dict:
    """Config `name`'s row on seq (config 5: a list of sequences)."""
    import eval_configs as ec
    from vislam_tpu.eval import ate_rmse

    def ate(r):
        return float(ate_rmse(r["poses"], r["gt"], align=False))

    if name == "1":
        r = ec.run_vio(seq, gt_scale=True)
        return {"ate": ate(r)}
    if name == "2":
        r = ec.run_vio(seq, gt_scale=False)
        r_vb = ec.run_vio(seq, gt_scale=False, vi_ba=True)
        r_un = ec.run_vio(seq, cfg=_with(engine=dict(vi_align_bootstrap=False)),
                          gt_scale=False)
        gl = _path_length(r["gt"])
        return {"ate": ate(r), "scale_ratio": _path_length(r["poses"]) / gl,
                "ate_vi_ba": ate(r_vb), "scale_ratio_vi_ba": _path_length(r_vb["poses"]) / gl,
                "ate_open_unsupervised": ate(r_un)}
    if name == "3":
        return {
            "ate_plain": ate(ec.run_vio(seq, gt_scale=True)),
            "ate_photometric": ate(ec.run_vio(seq, gt_scale=True, photometric=True)),
            "ate_online_ba": ate(ec.run_vio(seq, gt_scale=True, ba=True)),
            "ate_vi_open_loop": ate(ec.run_vio(seq, gt_scale=False)),
            "ate_vi_online_ba_ends": ate(ec.run_vio(seq, gt_scale=False, vi_ba=True)),
            "ate_vi_online_ba_marg": ate(ec.run_vio(
                seq, cfg=_with(backend=dict(online_gauge="marg")), gt_scale=False,
                vi_ba=True)),
        }
    if name == "4":
        r = ec.run_vio(seq, gt_scale=True, loop_correct=True)
        return {"ate_open_loop": ate(r), "n_loops": len(r.get("loops", [])),
                "kf_maxerr_before": r.get("kf_err_before"),
                "kf_maxerr_after": r.get("kf_err_after")}
    if name == "5":
        r = run_batch(seq, seed)
        r.pop("poses")
        return r
    if name == "2c":
        return {k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in ec.run_cold(seq).items()}
    r = ec.run_long(seq)
    return {k: (float(v) if isinstance(v, (float, np.floating)) else v) for k, v in r.items()}


def _first_apart(a, b, tol: float):
    """The first frame (1-based) where poses a and b (N, 3) part by more
    than tol (max norm), or None."""
    far = np.nonzero(np.abs(np.asarray(a) - np.asarray(b)).max(-1) > tol)[0]
    return int(far[0]) + 1 if len(far) else None


# The `run_vio` options of each trajectory a row's metric is read from
# (configs 1, 2, 3 and 4; "cfg": SystemConfig sections replaced); 2c's
# rows come from the cold start (`run_cold`: "cold" names the trajectory,
# the live poses or the bootstrap-smoothed ones).
LOCATABLE = {
    ("1", "ate"): dict(gt_scale=True),
    ("2", "ate"): dict(gt_scale=False),
    ("2", "scale_ratio"): dict(gt_scale=False),
    ("2", "ate_vi_ba"): dict(gt_scale=False, vi_ba=True),
    ("2", "scale_ratio_vi_ba"): dict(gt_scale=False, vi_ba=True),
    ("2", "ate_open_unsupervised"): dict(gt_scale=False,
                                         cfg=dict(engine=dict(vi_align_bootstrap=False))),
    ("3", "ate_plain"): dict(gt_scale=True),
    ("3", "ate_photometric"): dict(gt_scale=True, photometric=True),
    ("3", "ate_online_ba"): dict(gt_scale=True, ba=True),
    ("3", "ate_vi_open_loop"): dict(gt_scale=False),
    ("3", "ate_vi_online_ba_ends"): dict(gt_scale=False, vi_ba=True),
    ("3", "ate_vi_online_ba_marg"): dict(gt_scale=False, vi_ba=True,
                                         cfg=dict(backend=dict(online_gauge="marg"))),
    ("4", "ate_open_loop"): dict(gt_scale=True),
    ("2c", "ate_live"): dict(cold="poses", gt_scale=False),
    ("2c", "ate_smoothed"): dict(cold="smoothed", gt_scale=False),
}


def cold_reference(seq) -> dict:
    """`scripts/eval_configs.py`'s `run_cold` (config 2c) with its
    trajectories: the live poses and the bootstrap-smoothed ones (that
    function returns only their ATEs)."""
    from torch_eval_configs import _imu
    from vislam_tpu.engine import VIOEngine
    from vislam_tpu.engine.refine import refine_window
    from vislam_tpu.eval import smooth_bootstrap_prefix

    calib = seq["calib"]
    eng = VIOEngine(calib, _with(backend=dict(vi_factors=True)))
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0], v_w0=np.zeros(3),
                           p_w0=seq["gt_pos"][0])
    poses, shadows, applies = [], [], []
    for j in range(1, len(seq["images"])):
        imu, dt = _imu(seq, j)
        state, res = eng.step(state, seq["images"][j], imu, dt, -1.0)
        if bool(res.is_keyframe):
            state = refine_window(state, eng.cfg, calib.fx, calib.fy, calib.cx, calib.cy)
        poses.append(np.asarray(state.p_wc))
        shadows.append(np.asarray(state.shadow_p_wc))
        applies.append(int(state.bootstrap_applies))
    poses = np.array(poses)
    return {"poses": poses, "smoothed": smooth_bootstrap_prefix(
        poses, np.array(shadows), np.array(applies), np.asarray(state.origin_p_wc),
        np.asarray(state.shadow_origin_p))}


def locate(config: str, metric: str, seed: int) -> dict:
    """Where the port's trajectory behind row `config` `metric` parts from
    the reference's at RANSAC seed `seed` (both draw the same hypotheses
    since the port copies JAX's stream): the reference's run (draw 0), its
    ULP_DRAWS one-ulp IMU draws and the port's run on the CPU
    (`scripts/torch_eval_configs.py`'s runner), frame by frame: the first
    frame where each parts from draw 0 by more than 1e-6 m and by more
    than 1e-4 m, the largest gap, each ATE; and whether the port parts
    (1e-4 m) earlier than every one of the reference's own draws."""
    import eval_configs as ec
    import torch_eval_configs as tc
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu.eval import ate_rmse
    from vislam_tpu_torch.data import make_synthetic_sequence as port_sequence
    from vislam_tpu_torch.data import SyntheticConfig as PortConfig

    opts = dict(LOCATABLE[(config, metric)])
    sections = opts.pop("cfg", {})
    cold = opts.pop("cold", None)
    kw = CONFIGS[config][0]
    seq = make_synthetic_sequence(SyntheticConfig(**kw))
    seeded(seed)

    def reference(s):
        return (cold_reference(s)[cold] if cold else
                ec.run_vio(s, cfg=_with(**sections), **opts)["poses"])

    runs = {"reference": reference(seq)}
    for k in range(1, ULP_DRAWS + 1):
        runs[f"reference, 1 ulp draw {k}"] = reference(perturbed(seq, k))
    port_seq = port_sequence(PortConfig(**kw))
    runs["port (CPU)"] = (tc.run_cold(port_seq, "cpu", seed)[cold] if cold else
                          tc._vio(port_seq, "cpu", seed, tc._with(**sections), **opts)["poses"])
    gt = seq["gt_pos"][1:len(seq["images"])]
    out = {"config": config, "metric": metric, "seed": seed,
           "ate": {k: float(ate_rmse(v, gt, align=False)) for k, v in runs.items()}}
    ref = runs["reference"]
    for name, p in runs.items():
        if name == "reference":
            continue
        out[name] = dict(apart_1e6=_first_apart(p, ref, 1e-6), apart_1e4=_first_apart(p, ref, 1e-4),
                         max_dp=float(np.abs(p - ref).max()))
        print(f"config {config} {metric} seed {seed}: {name} against the reference: positions "
              f"part (> 1e-6 m) first at frame {out[name]['apart_1e6']}, (> 1e-4 m) at frame "
              f"{out[name]['apart_1e4']}; largest |dp| {out[name]['max_dp']:.3e} m; ATE "
              f"{out['ate'][name]:.6f} against {out['ate']['reference']:.6f} m", flush=True)
    never = len(ref) + 1
    draws = [out[f"reference, 1 ulp draw {k}"]["apart_1e4"] or never
             for k in range(1, ULP_DRAWS + 1)]
    out["port_first"] = bool((out["port (CPU)"]["apart_1e4"] or never) < min(draws))
    print(f"config {config} {metric} seed {seed}: the port parts (> 1e-4 m) "
          f"{'earlier than every' if out['port_first'] else 'no earlier than some'} one-ulp "
          f"draw of the reference", flush=True)
    return out


def _tuple(values) -> str:
    return f'({", ".join(values)}{"," if len(values) == 1 else ""})'


def reference_lines(table: dict) -> str:
    """The ensemble's keys for `REFERENCE` in `scripts/torch_eval_configs.py`,
    per config and metric, where measured: "ulp" the four one-ulp values at
    each seed (to 1e-6), "spread" the largest move from draw 0 at each seed
    (3 digits), "nofma" the no-FMA compile's value at each seed (to
    1e-6)."""
    lines = []
    for c, metrics in table.items():
        for m, e in metrics.items():
            line = f'"{c}" "{m}":'
            if "tpu" in e:
                line += (f' draw 0 {_tuple([f"{v:.6f}" for v in e["tpu"]])},\n'
                         f'    ulp={_tuple([_tuple([f"{v:.6f}" for v in u]) for u in e["ulp"]])},'
                         f'\n    spread={_tuple([f"{v:.3g}" for v in e["spread"]])},')
            if "nofma" in e:
                line += f'\n    nofma={_tuple([f"{v:.6f}" for v in e["nofma"]])},'
            lines.append(line)
    return "\n".join(lines)


def lockstep(config: str, metric: str, seed: int, frames: int) -> list:
    """The port's step (on the CPU) from the reference's state at every
    frame of the trajectory behind row `config` `metric` (its step
    options; no refine, but 2c's, which refines the window on each
    keyframe: both packages refine their stepped states), against the
    reference's own step at RANSAC seed
    `seed`: per frame the position apart, the decisions that differ and
    the state fields apart most (max |d|); on keyframes also the
    keyframe depths of points both keep. What one step of the port
    changes, apart from what earlier steps accumulated."""
    import jax

    import torch_eval_configs as tc
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu.engine import VIOEngine as JEngine
    from vislam_tpu.engine.refine import refine_window as j_refine
    from vislam_tpu_torch.engine import VIOEngine as TEngine
    from vislam_tpu_torch.engine.refine import refine_window as t_refine
    from vislam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    opts = dict(LOCATABLE[(config, metric)])
    sections = dict(opts.pop("cfg", {}))
    cold = opts.pop("cold", None)
    if cold:
        sections["backend"] = dict(sections.get("backend", {}), vi_factors=True)
    if opts.get("photometric"):
        sections["engine"] = dict(sections.get("engine", {}), photometric_refine=True)
    seq = make_synthetic_sequence(SyntheticConfig(**CONFIGS[config][0]))
    c = seq["calib"]
    je = JEngine(c, _with(**sections), seed=seed)
    te = TEngine(c, tc._with(**sections), seed, device="cpu")
    init = dict(q_wb0=seq["gt_quat"][0], v_w0=np.zeros(3) if cold else seq["gt_vel"][0],
                p_w0=seq["gt_pos"][0])
    js = je.initialize(seq["images"][0], **init)

    def fields(st):
        out = {}
        for path, v in jax.tree_util.tree_leaves_with_path(st):
            v = np.asarray(v)
            if v.dtype.kind == "f" or v.dtype.name == "bfloat16":
                out[jax.tree_util.keystr(path)] = v.astype(np.float64)
        return out

    out, last_kf = [], 0
    for j in range(1, min(frames, len(seq["images"]))):
        imu, dt = tc._imu(seq, j)
        g = (float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
             if opts["gt_scale"] else -1.0)
        te.set_step_counter(j - 1)
        ts, tres = te.step(state_from_numpy(jax.tree.map(np.asarray, js), "cpu"),
                           seq["images"][j], imu, dt, g)
        js, jres = je.step(js, seq["images"][j], imu, dt, g)
        refine = ""
        if cold and bool(jres.is_keyframe):
            def v_apart():
                return float(np.abs(np.asarray(js.window.v_w) - ts.window.v_w.numpy()).max())

            before = v_apart()
            js = j_refine(js, je.cfg, c.fx, c.fy, c.cx, c.cy)
            ts = t_refine(ts, te.cfg, c.fx, c.fy, c.cx, c.cy)
            refine = (f"; window velocities apart {before:.1e} after the step, {v_apart():.1e} "
                      f"after both refines (engaged {bool(js.vi_engaged)} / "
                      f"{bool(ts.vi_engaged)})")
        a, b = fields(js), fields(state_to_numpy(ts))
        apart = sorted(((float(np.abs(a[k] - b[k]).max()), k) for k in a
                        if k in b and a[k].shape == b[k].shape), reverse=True)[:4]
        rec = {"frame": j, "dp": float(np.abs(np.asarray(js.p_wc) - ts.p_wc.numpy()).max()),
               "decisions": [f for f in ("num_matches", "num_inliers", "used_fallback",
                                         "is_keyframe")
                             if int(getattr(jres, f)) != int(getattr(tres, f))],
               "fields": apart}
        if bool(jres.is_keyframe):
            last_kf = j
            both = np.asarray(js.kf_depth_valid) & state_to_numpy(ts).kf_depth_valid
            d = np.abs(a[".kf_depths"] - b[".kf_depths"])[both]
            rec["kf_depths"] = (float(d.max()) if d.size else 0.0,
                                float(a[".kf_depths"][both].max()) if d.size else 0.0)
        print(f"config {config} {metric} seed {seed} frame {j}: the port's step from the "
              f"reference's state: |dp| {rec['dp']:.2e} m; decisions differ "
              f"{rec['decisions']}; fields apart most "
              f"{', '.join(f'{k} {v:.1e}' for v, k in apart)}"
              + (f"; keyframe depths apart by up to {rec['kf_depths'][0]:.2e} m (depths up "
                 f"to {rec['kf_depths'][1]:.1f} m)" if "kf_depths" in rec else "") + refine,
              flush=True)
        out.append(rec)
    return out


def _recorded(module, store: list, to_host):
    """Replace `module.optimize_pose_graph` by a wrapper that appends
    (its pose graph, its info) on the host to `store` on every call."""
    inner = module.optimize_pose_graph

    def wrapper(pg, **kw):
        out, info = inner(pg, **kw)
        store.append(({k: to_host(v) for k, v in pg._asdict().items()}, kw,
                      {k: to_host(v) for k, v in info.items()}))
        return out, info

    module.optimize_pose_graph = wrapper


def _iterations(info) -> list:
    """[(cost, accepted)] of each Gauss-Newton iteration: an iteration is
    accepted where it lowers the cost (both packages keep the cost
    otherwise)."""
    costs = [float(info["initial_cost"])] + [float(c) for c in info["costs"]]
    return [(c, c < prev) for prev, c in zip(costs, costs[1:])]


def locate_correction(seed: int) -> dict:
    """Config 4's loop correction at RANSAC seed `seed`: the port's run on
    the CPU archives its keyframes (`scripts/torch_eval_configs.py`'s
    `run_loop`), then the reference's and the port's `correct_trajectory` run
    on that same archive: the loops, the keyframes' largest error after
    each, the corrected positions apart, each final cost; then the pose
    graphs each built (edges and nodes apart) and, iteration by iteration,
    the cost and accept flag of the reference's `optimize_pose_graph`, the
    port's on its own graph and the port's on the reference's graph (the
    optimizer apart from the loop measurements). Run it with and without
    --nofma for both of the reference's compiles."""
    import torch

    import torch_eval_configs as tc
    from vislam_tpu.backend import trajectory_opt as jto
    from vislam_tpu_torch.backend import pose_graph as tpg
    from vislam_tpu_torch.backend import trajectory_opt as tto
    from vislam_tpu_torch.data import SyntheticConfig as PortConfig
    from vislam_tpu_torch.data import make_synthetic_sequence as port_sequence

    seq = port_sequence(PortConfig(**CONFIGS["4"][0]))
    c = seq["calib"]
    archive = tc.run_loop(seq, "cpu", seed)["archive"]
    kf_gt = np.array([seq["gt_pos"][k.frame_index] for k in archive])
    kw = dict(min_separation=10, sim_thresh=0.80, min_inliers=25)
    graphs = {"port": [], "reference": []}
    _recorded(tto, graphs["port"], lambda v: v.cpu().numpy() if torch.is_tensor(v) else v)
    _recorded(jto, graphs["reference"], np.asarray)
    t_p, _, t_info = tto.correct_trajectory(archive, c.fx, c.fy, c.cx, c.cy, device="cpu", **kw)
    j_p, _, j_info = jto.correct_trajectory([jto.KeyframeRecord(*k) for k in archive],
                                            c.fx, c.fy, c.cx, c.cy, **kw)
    out = {"seed": seed, "loops_equal": [tuple(x) for x in t_info["loops"]]
           == [tuple(x) for x in j_info["loops"]],
           "kf_maxerr_after": {"port": float(np.linalg.norm(t_p - kf_gt, axis=-1).max()),
                               "reference": float(np.linalg.norm(np.asarray(j_p) - kf_gt,
                                                                 axis=-1).max())},
           "max_dp": float(np.abs(t_p - np.asarray(j_p)).max()),
           "final_cost": {"port": t_info["final_cost"], "reference": float(j_info["final_cost"])}}
    print(f"config 4 seed {seed}: both corrections of the port's archive ({len(archive)} "
          f"keyframes): loops equal {out['loops_equal']}; keyframe error after "
          f"{out['kf_maxerr_after']['port']:.6f} (port) / "
          f"{out['kf_maxerr_after']['reference']:.6f} (reference) m; positions apart by up to "
          f"{out['max_dp']:.2e} m; final cost {out['final_cost']['port']:.6f} / "
          f"{out['final_cost']['reference']:.6f}", flush=True)
    print(f"config 4 seed {seed}: loops (a, b, inliers) port {t_info['loops']} / reference "
          f"{j_info['loops']}", flush=True)
    if not (graphs["port"] and graphs["reference"]):
        return out
    (tg, _, t_run), (jg, j_kw, j_run) = graphs["port"][-1], graphs["reference"][-1]
    same = all(tg[k].shape == jg[k].shape for k in tg)
    n_odo = len(jg["R"]) - 1     # edges (i, i + 1) first, then one per loop

    def gap(k, edges=slice(None)):
        return float(np.abs(tg[k][edges].astype(np.float64) - jg[k][edges]).max()) \
            if same and len(jg[k][edges]) else None

    apart = {k: gap(k) for k in ("R", "t", "edge_weight")}
    apart.update({f"odometry {k}": gap(k, slice(None, n_odo)) for k in ("edge_R", "edge_t")})
    apart.update({f"loop {k}": gap(k, slice(n_odo, None)) for k in ("edge_R", "edge_t")})
    if same:
        for (a, b, n_t), (_, _, n_j), k in zip(t_info["loops"], j_info["loops"],
                                                range(n_odo, len(jg["edge_i"]))):
            dR = np.abs(tg["edge_R"][k] - jg["edge_R"][k]).max()
            dt = np.abs(tg["edge_t"][k] - jg["edge_t"][k]).max()
            print(f"config 4 seed {seed} loop ({a}, {b}): inliers port {n_t} / reference "
                  f"{n_j}; measured edge apart: R {dR:.2e}, t {dt:.2e} m", flush=True)
    port_graph = tpg.PoseGraph(*(torch.from_numpy(np.array(jg[k])) for k in jg))
    moved, on_ref = tpg.optimize_pose_graph(port_graph, **j_kw)
    on_ref = {k: v.numpy() for k, v in on_ref.items()}
    runs = {"reference": _iterations(j_run), "port": _iterations(t_run),
            "port on the reference's graph": _iterations(on_ref)}
    out["graph_apart"] = apart
    out["iterations"] = runs
    out["port_on_reference_graph_dp"] = float(np.abs(moved.t.numpy() - np.asarray(j_p)).max())
    print(f"config 4 seed {seed}: the pose graphs ({len(jg['R'])} nodes, {len(jg['edge_i'])} "
          f"edges, {j_kw}): edge lists equal "
          f"{same and bool(np.array_equal(tg['edge_i'], jg['edge_i']))}; apart (max |d|) "
          + ", ".join(f"{k} {v:.2e}" for k, v in apart.items() if v is not None)
          + f"; the port's optimizer on the reference's graph ends "
            f"{out['port_on_reference_graph_dp']:.2e} m from the reference's positions",
          flush=True)
    for i, rows in enumerate(zip(*runs.values()), start=1):
        print(f"config 4 seed {seed} iteration {i}: "
              + "; ".join(f"{name} cost {cost:.7f} {'accepted' if ok else 'rejected'}"
                          for name, (cost, ok) in zip(runs, rows)), flush=True)
    return out


def ensemble(configs, jobs: int, out_path=None, part: str = "all") -> dict:
    """The reference's per-seed ensemble (see the module docstring): one
    `--vary ulp --branch tpu --seed d` process per (config, seed), per
    draw for config 6, and one `--nofma` process per (config, seed),
    `jobs` at a time, the longest first; `part` "nofma" runs only those."""
    order = {"6": 0, "3": 1, "2": 2, "4": 3, "2c": 4, "5": 5, "1": 6}
    tasks = []
    for c in sorted(configs, key=order.get):
        for d in ENSEMBLE_SEEDS[c]:
            if part == "all":
                spans = [(k, 1) for k in range(ULP_DRAWS + 1)] if c == "6" else [(0, ULP_DRAWS + 1)]
                tasks += [(c, d, first, n, False) for first, n in spans]
            tasks.append((c, d, 0, 1, True))
    results, nofma, seconds = {}, {}, {}
    t_all = time.perf_counter()

    def run(task, td):
        c, d, first, n, no_fma = task
        tag = f"{c}/{d}/{'nofma' if no_fma else first}"
        path = os.path.join(td, tag.replace("/", "-") + ".json")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--config", c, "--vary", "ulp",
                        "--branch", "tpu", "--seed", str(d), "--first", str(first), "--draws",
                        str(n), "--out", path] + (["--nofma"] if no_fma else []),
                       stdout=subprocess.DEVNULL, check=True)
        seconds[tag] = time.perf_counter() - t0
        what = "no-FMA draw 0" if no_fma else f"draws {first}-{first + n - 1}"
        print(f"config {c} seed {d} {what}: {seconds[tag]:.0f} s", flush=True)
        with open(path) as fh:
            return c, d, no_fma, json.load(fh)

    with tempfile.TemporaryDirectory() as td, ThreadPoolExecutor(jobs) as pool:
        for c, d, no_fma, got in pool.map(run, tasks, [td] * len(tasks)):
            rows = {int(k): v for k, v in got["rows"].items()}
            if no_fma:
                nofma.setdefault(c, {})[d] = rows[0]
            else:
                results.setdefault(c, {}).setdefault(d, {}).update(rows)
    table = {}
    for c in sorted(set(results) | set(nofma), key=order.get):
        for m in CONFIGS[c][1]:
            e = table.setdefault(c, {}).setdefault(m, {})
            if c in results:
                seeds = sorted(results[c])
                e["tpu"] = [results[c][d][0][m] for d in seeds]
                e["ulp"] = [[results[c][d][k][m] for k in range(1, ULP_DRAWS + 1)] for d in seeds]
                e["spread"] = [max(abs(v - t) for v in u) for t, u in zip(e["tpu"], e["ulp"])]
            if c in nofma:
                e["nofma"] = [nofma[c][d][m] for d in sorted(nofma[c])]
    import jax

    out = {"ensemble": table, "seconds": seconds, "wall_s": time.perf_counter() - t_all,
           "process_s": sum(seconds.values()), "host": host_isa(), "jax": jax.__version__,
           "command": " ".join(sys.argv)}
    print(reference_lines(table))
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS))
    ap.add_argument("--vary", default="ulp", choices=["ulp", "seed"])
    ap.add_argument("--seed", type=int, default=0,
                    help="the RANSAC seed of --vary ulp and --locate")
    ap.add_argument("--ensemble", action="store_true",
                    help="the per-seed ensemble of every config in --configs")
    ap.add_argument("--configs", default="1,2,2c,3,4,5,6")
    ap.add_argument("--jobs", type=int, default=8, help="--ensemble: processes at a time")
    ap.add_argument("--part", default="all", choices=["all", "nofma"],
                    help="--ensemble: every run, or only the no-FMA runs")
    ap.add_argument("--nofma", action="store_true",
                    help=f"compile without fused multiply-adds (XLA_FLAGS += {NOFMA_FLAG})")
    ap.add_argument("--branch", default="cpu", choices=["cpu", "tpu"])
    ap.add_argument("--draws", type=int, default=4, help="draws in all, draw 0 included")
    ap.add_argument("--first", type=int, default=0, help="first draw")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--locate", default=None, metavar="METRIC",
                    help="locate where the port's trajectory behind --config's METRIC parts "
                         "from the reference's at --seed (config 4's loop correction: "
                         "--config 4 --locate correction)")
    ap.add_argument("--lockstep", default=None, metavar="METRIC",
                    help="the port's step from the reference's state at each frame of "
                         "--config's METRIC at --seed")
    ap.add_argument("--frames", type=int, default=20, help="--lockstep: frames")
    args = ap.parse_args()
    if args.ensemble:
        ensemble(args.configs.split(","), args.jobs, args.out, args.part)
        return
    if args.config is None:
        ap.error("--config is required")
    if args.nofma:
        os.environ["XLA_FLAGS"] = f"{os.environ.get('XLA_FLAGS', '')} {NOFMA_FLAG}".strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    compiled = check_compile(args.nofma)
    print(f"the reference compiles a * c - b * b {compiled} (XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}; host {host_isa()})", flush=True)
    from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence

    if args.branch == "tpu":
        tpu_branch()
    if args.locate == "correction" and args.config == "4":
        print(json.dumps(locate_correction(args.seed)))
        return
    if args.locate:
        print(json.dumps(locate(args.config, args.locate, args.seed)))
        return
    if args.lockstep:
        print(json.dumps(lockstep(args.config, args.lockstep, args.seed, args.frames)))
        return
    kw, metrics = CONFIGS[args.config]
    if args.config == "5":
        seq = [make_synthetic_sequence(SyntheticConfig(**{**kw, "seed": s})) for s in range(8)]
    else:
        seq = make_synthetic_sequence(SyntheticConfig(**kw))
    rows = {}
    if args.vary == "ulp":
        seeded(args.seed)
    for d in range(args.first, args.first + args.draws):
        t0 = time.perf_counter()
        if args.vary == "seed":
            seeded(d)
            rows[d] = run_config(args.config, seq, seed=d)
        elif args.config == "5":
            rows[d] = run_config(args.config, [perturbed(s, d) for s in seq], seed=args.seed)
        else:
            rows[d] = run_config(args.config, perturbed(seq, d))
        print(f"config {args.config} draw {d}: {rows[d]} ({time.perf_counter() - t0:.0f} s)",
              flush=True)
    out = {"config": args.config, "vary": args.vary, "branch": args.branch, "rows": rows,
           "nofma": args.nofma, "compile": compiled}
    if args.vary == "ulp":
        out["seed"] = args.seed
    if 0 in rows and len(rows) > 1:
        out["spread"] = {m: max(abs(r[m] - rows[0][m]) for d, r in rows.items() if d)
                         for m in metrics if m in rows[0]}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once and print its result line.

    python3 vio_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`vislam_tpu_torch`) and
`BENCHMARK.json`. The cell names a configuration (`configs/<name>.json`:
the deployment, its scene and its `SystemConfig`) and a traffic mix
(`traffic/<name>.json`: how many sequences are stepped together and
whether they carry ground truth); `workloads/<name>.json` holds the
limits of its correctness check. Per-layer metrics are read by
`metrics/<name>.py`. Everything is found by the names in BENCHMARK.json.

Set-up (counted in `setup_s`, from process start): the B sequences from
the seed (trajectory, IMU and landmarks on the host, frames rendered on
the card), B engine states, one short warm-up pass. The window: passes of
`run_batch_scan` over the B x N frames from those states, back to back
with no host sync inside, each keyed by a seed drawn from --seed and its
index, until --seconds have passed; then one synchronise. With --trace 1
the window is one pass under the profiler and the per-layer metrics are
reported. After the window the outputs are checked against the plain
reference (`check.py`), and the run fails if the process has loaded JAX or
the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".vio_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vislam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`vislam_tpu_torch` is not `vislam_tpu`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"vio_bench {time.perf_counter() - T_START:8.2f} s: {msg}", file=sys.stderr, flush=True)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and the per-layer metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[cell["config"]]["file"]))
    return SimpleNamespace(
        name=name, cell=cell, config=config,
        traffic=_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        workload=_json(os.path.join(HERE, "workloads", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"] if name in m.get("workloads", [name])])


def metric_reader(name: str):
    """`read(ctx)` of metrics/<name>.py: the metric's value, or None where it
    finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_config(d: dict):
    from vislam_tpu_torch.utils.config import (
        BackendConfig, EngineConfig, FrontendConfig, SystemConfig)
    top = {k: v for k, v in d.items() if k not in ("frontend", "backend", "engine")}
    return SystemConfig(frontend=FrontendConfig(**d["frontend"]),
                        backend=BackendConfig(**d["backend"]),
                        engine=EngineConfig(**d["engine"]), **top)


def pass_seed(seed: int, p: int) -> int:
    """Pass p's draw seed (31 bits) from the run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, 4, p]).generate_state(1)[0]) >> 1


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False) -> dict:
    """Set up, run the window, check; returns the result line's fields and
    the check's numbers (with `control`, also the control's under
    "control"). Does not look for a card: `device` is used as given."""
    from vio_bench import check, generator
    from vio_bench.trace import traced
    from vislam_tpu_torch.calib.camera_model import CameraCalib
    from vislam_tpu_torch.engine import batch as batch_mod
    from vislam_tpu_torch.engine import VIOEngine, stack_states

    log("imported")
    system = c.config["system"]
    traffic = generator.Traffic.from_json({**c.config["scene"], "frames": c.config["frames"],
                                           "landmarks": c.config["landmarks"],
                                           **generator.imu_noise(c.config["imu"]), **c.traffic})
    if not traffic.gt_scale:
        raise ValueError("the check composes GT-scaled poses: GT-free traffic has no check yet")
    cam = generator.Camera(**c.config["camera"])
    B, N = traffic.sequences, traffic.frames
    batch = generator.make_batch(traffic, seed, cam, system["engine"]["imu_window"], device, log)
    log(f"{B} sequences x {N + 1} frames generated")
    calib = CameraCalib(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, dist=(0.0, 0.0, 0.0, 0.0),
                        width=cam.width, height=cam.height, rate_cam_hz=generator.CAM_RATE_HZ,
                        rate_imu_hz=generator.IMU_RATE_HZ)
    eng = VIOEngine(calib, system_config(system), device=device)
    states0 = stack_states([eng.initialize(batch.images[b, 0], q_wb0=batch.gt_quat[b, 0],
                                           v_w0=batch.gt_vel[b, 0], p_w0=batch.gt_pos[b, 0])
                            for b in range(B)])
    log(f"{B} states initialised")
    gt_pos = torch.as_tensor(batch.gt_pos, dtype=torch.float32, device=device)
    inputs = batch_mod.SequenceInputs(images=batch.images[:, 1:], imu=batch.imu,
                                      imu_dt=batch.imu_dt, gt_pos=gt_pos[:, 1:],
                                      use_gt_scale=traffic.gt_scale)
    kf0 = gt_pos[:, 0]
    cuda = torch.device(device).type == "cuda"

    def one_pass(p, inp=inputs):
        return batch_mod.run_batch_scan(eng, states0, inp, kf0, seed=pass_seed(seed, p))[1]

    warm = 2
    one_pass(10 ** 6, inputs._replace(images=inputs.images[:, :warm], imu=inputs.imu[:, :warm],
                                      imu_dt=inputs.imu_dt[:, :warm],
                                      gt_pos=inputs.gt_pos[:, :warm]))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log("warmed up")
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    results, tr, marks = [], None, [t0]
    if trace:
        tr = traced(lambda: results.append(one_pass(0)), steps=N)
        window_s = tr.window_s
    else:
        while True:
            results.append(one_pass(len(results)))
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    res = check.host_results(results)
    P = len(results)
    err = res["p_wc"].astype(np.float64) - batch.gt_pos[None, :, 1:]
    finite = np.isfinite(err).all(-1)
    ate = float(np.sqrt(np.mean(np.sum(err[finite] ** 2, -1)))) if finite.any() else float("inf")
    # A pass's host time is its time while the host paces the step.
    log(f"window: {P} passes in {window_s:.3f} s, peak {peak / 2 ** 30:.2f} GiB; "
        f"passes enqueued in {[round(b - a, 3) for a, b in zip(marks, marks[1:])]} s; "
        f"rescue taken on {100.0 * float(res['used_fallback'].mean()):.3f}% of frames")
    del eng, states0, inputs, results
    if cuda:
        torch.cuda.empty_cache()

    compared = check.compare(res, batch, [pass_seed(seed, p) for p in range(P)], seed, system,
                             cam, c.workload["sample_frames"], device, control)
    readings = compared["program"]
    log("checked")
    limits = c.workload["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in check.NUMBERS}
    failed = int((~finite).sum())
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in checks.values())

    values = {"frames_per_s": P * B * N / window_s, "ate_rmse_m": ate, "setup_s": setup_s}
    metrics = {}
    if trace:
        ctx = SimpleNamespace(trace=tr, peak_bytes=peak, system=system, B=B, N=N,
                              H=cam.height, W=cam.width)
        for m in c.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": P * B * N, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    if control:
        out["control"] = compared["control"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    c = load_cell(a.workload)
    chips = int(c.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vio_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    out = run_cell(c, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"vio_bench: the run loaded {bad}: JAX and the JAX package must stay out",
              file=sys.stderr)
        return 1
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

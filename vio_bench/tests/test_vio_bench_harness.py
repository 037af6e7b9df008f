"""The harness without the card: BENCHMARK.json against the benchmark's
contract, cells and metrics found by name, the roofline arithmetic, the
import guard, and the result line of a cell rehearsed on the CPU."""

import json
import os
import re
import sys
import types

import pytest
import torch

from vio_bench import check, roofline, run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["vio_bench"] and 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vio_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) == set(json.load(f)["reduced"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"frames_per_s", "ate_rmse_m", "setup_s"} == set(e2e)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs = [(v["config"], v["traffic"]) for v in bench["workloads"]]
        assert len(pairs) == len(set(pairs))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["sift_b512", "kaze_b512"])
def test_cells_and_metrics_are_found_by_name(cell):
    c = run.load_cell(cell)
    assert c.config["name"] == c.cell["config"]
    assert tuple(c.workload["limits"]) == check.NUMBERS
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "ate_rmse_m", "setup_s"}
    for m in c.per_layer:
        assert callable(run.metric_reader(m["name"]))
    fed = [m["name"] for m in c.per_layer if m["name"] == "fed_evolve_roofline"]
    assert bool(fed) == (c.config["system"]["frontend"]["scale_space"] == "nonlinear")


# Bounds per call in microseconds as chip_smoke.py prints them (its
# `bound B us` lines, PERF.md's table of kernels).
@pytest.mark.parametrize("got, want", [
    (lambda: roofline.response_nms_s("shi_tomasi", 1, 480, 752), 1.293),
    (lambda: roofline.response_nms_s("shi_tomasi", 1, 240, 376), 0.323),
    (lambda: roofline.response_nms_s("harris", 1, 480, 752), 1.293),
    (lambda: roofline.response_nms_s("dog", 1, 240, 376), 0.323),
    (lambda: roofline.response_nms_s("fast", 1, 480, 752), 1.772),
    (lambda: roofline.response_nms_s("fast", 4, 480, 752), 7.090),
    (lambda: roofline.response_nms_s("hessian", 4, 480, 752), 5.172),
    (lambda: roofline.response_nms_s("_gradmag2", 1, 480, 752), 0.862),
    (lambda: roofline.match_top2_s(1, 768, 768, 128, False), 0.977),
    (lambda: roofline.match_top2_s(1, 768, 768, 128, True), 1.030),
    (lambda: roofline.match_top2_s(1, 512, 512, 128, False), 0.434),
    (lambda: roofline.match_top2_s(8, 768, 768, 128, False), 7.814),
    (lambda: roofline.threefry_categorical_s(1, 2, 512, 768), 3.532),
    (lambda: roofline.threefry_categorical_s(8, 2, 512, 768), 28.255),
    (lambda: roofline.fed_evolve_s(1, 480, 752, 4), 1.315),
    (lambda: roofline.fed_evolve_s(1, 480, 752, 8), 2.629),
    (lambda: roofline.fed_evolve_s(4, 480, 752, 4), 5.258),
])
def test_roofline_arithmetic_matches_chip_smoke_bounds(got, want):
    assert got() * 1e6 == pytest.approx(want, abs=1.5e-3)


def test_fed_cycles_of_the_nonlinear_scale_space():
    assert roofline.fed_steps(0.5 * (1.6 ** 2 - 1.0)) == 4
    assert roofline.fed_steps(1.5 * 1.6 ** 2) == 8


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    import vislam_tpu_torch  # noqa: F401  (a name that begins with the JAX package's)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vislam_tpu.engine", types.ModuleType("vislam_tpu.engine"))
    assert run.forbidden_modules() == ["vislam_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "vislam_tpu"]


def _stub_result():
    return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {"platform": "gpu", "kind": "stub", "count": 1, "memory_peak_bytes": 1},
            "checks": {"frames_apart_pct": {"value": 0.0, "limit": 1.0}}}


def test_guard_refuses_a_run_that_loaded_jax(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: _stub_result())
    assert run.main(["--workload", "sift_b512", "--seed", "1", "--seconds", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"] is True
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.main(["--workload", "sift_b512", "--seed", "1", "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "jaxlib" in out.err


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "kaze_b512", "--seed", str(2 ** 33), "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_pass_seeds_take_any_whole_seed():
    seeds = {run.pass_seed(2 ** 40 + 3, p) for p in range(50)}
    assert len(seeds) == 50 and all(0 <= s < 2 ** 31 for s in seeds)


def test_trace_readers_on_a_made_up_trace():
    from types import SimpleNamespace

    from vio_bench.trace import Kernel, Trace

    # Two overlapping kernels (0-10 us, 5-15 us), one alone (20-30 us), a
    # copy (32-34 us): busy 27 us of 40, three kernels in two steps.
    ks = [Kernel("void response_nms_kernel<0>(float*)", 0, 10_000),
          Kernel("match_top2_kernel(float const*)", 5_000, 10_000),
          Kernel("reset_kernel(unsigned long long*, int, int*, int)", 20_000, 10_000),
          Kernel("Memcpy DtoD (Device -> Device)", 32_000, 2_000)]
    t = Trace(ks, 40e-6, steps=2)
    assert t.busy_s == pytest.approx(27e-6)
    assert len(t.kernels) == 3
    assert t.idle_gaps()[0][1] == pytest.approx(5e-6)
    system = run.load_cell("sift_b512").config["system"]
    ctx = SimpleNamespace(trace=t, peak_bytes=2 ** 31, system=system, B=256, N=40, H=480, W=752)
    assert run.metric_reader("device_idle_pct")(ctx) == pytest.approx(32.5)
    assert run.metric_reader("launches_per_step")(ctx) == 1.5
    assert run.metric_reader("peak_mem_gib")(ctx) == 2.0
    bounds = roofline.step_bounds(system, 256, 480, 752)
    assert run.metric_reader("match_top2_roofline")(ctx) == pytest.approx(
        100 * 2 * bounds["match_top2"] / 20e-6)
    assert run.metric_reader("fed_evolve_roofline")(ctx) is None
    assert run.metric_reader("threefry_categorical_roofline")(ctx) is None

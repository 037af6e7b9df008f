"""The port's EVAL holds (`scripts/torch_eval_configs.py`) on fixed
numbers, without running an engine: the paired rule at each seed
(|port_d - c| <= max(2 s_d, 1e-4) for c the reference's draw 0 or its
no-FMA compile at seed d, s_d the reference's one-ulp spread at seed d),
the count rule (within the reference's six runs at the seed), the range
(the union of draw 0's and the no-FMA values, widened by draw 0's IQR),
the median rule's one exception (the reference's ensemble where one of its
own one-ulp seed sets fails draw 0's median hold), and the table
`REFERENCE` against the seeds the harness runs. Also the premise of the
no-FMA runs on this host: XLA's CPU compile of det = a c - b^2 fuses a
multiply-add by default and rounds each product with `--xla_cpu_max_isa=AVX`
(`scripts/eval_reference_spread.py::compile_probe`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import eval_reference_spread as spread  # noqa: E402
import torch_eval_configs as h  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")

# Binary fractions, so that each distance below is exact.
BOUND_CASES = [
    # (spread, reference, port, held)
    (2.0 ** -11, 0.5, 0.5 + 2.0 ** -10, True),             # at 2 s
    (2.0 ** -11, 0.5, 0.5 - 2.0 ** -10, True),
    (2.0 ** -11, 0.5, 0.5 + 2.0 ** -10 + 2.0 ** -30, False),  # just above
    (2.0 ** -11, 0.5, 0.5 - 2.0 ** -10 - 2.0 ** -30, False),
    (1e-6, 0.0, 1e-4, True),                                # at the floor
    (1e-6, 0.0, 1.0001e-4, False),
    (0.0, 0.25, 0.25, True),
]


@pytest.mark.parametrize("spread,ref,port,held", BOUND_CASES)
def test_paired_rule_holds_at_its_bound_and_fails_above(spread, ref, port, held):
    table = dict(tpu=(ref,), ulp=((ref,) * 4,), spread=(spread,))
    assert h.paired_bound(spread) == max(2 * spread, 1e-4)
    name, _, ok = h.paired("ate", [port], table)
    assert name == "ate/paired" and ok is held


@pytest.mark.parametrize("port,held", [(4, True), (5, True), (6, True), (3, False),
                                       (7, False)])
def test_paired_count_rule_is_the_range_of_the_five_runs(port, held):
    table = dict(tpu=(5, 5), ulp=((5, 5, 5, 5), (4, 6, 5, 5)), spread=(0, 1))
    # Seed 0's five runs are all 5; seed 1's span 4-6.
    assert h.paired("n_loops", [5, port], table)[2] is held
    assert h.paired("n_loops", [port, 5], table)[2] is (port == 5)


def _ref(shift_set=None, shift=0.0, spread_set=None):
    """Eight draw-0 values 1..8 (median 4.5, IQR 3.5) and four one-ulp sets
    at draw 0 + 0.01 k; set `shift_set` moved by `shift`, set `spread_set`
    spread wide about its own median."""
    tpu = tuple(float(v) for v in range(1, 9))
    sets = [[v + 0.01 * k for v in tpu] for k in range(1, 5)]
    if shift_set is not None:
        sets[shift_set] = [v + shift for v in sets[shift_set]]
    if spread_set is not None:
        sets[spread_set] = [4.5 + 10 * (v - 4.5) for v in sets[spread_set]]
    return dict(tpu=tpu, ulp=tuple(zip(*sets)), spread=(0.0,) * 8)


def test_median_exception_applies_only_when_a_perturbed_set_fails():
    med, iqr = 4.5, 3.5
    # Every one-ulp set's median within draw 0's IQR: draw 0's median and IQR.
    assert h.median_reference(_ref()) == (med, iqr, False)
    # One set wide but centred: its median still holds, no exception.
    assert h.median_reference(_ref(spread_set=2)) == (med, iqr, False)
    # One set's median just inside the IQR: holds, no exception.
    at_edge = _ref(shift_set=0, shift=iqr - 0.02)
    assert h.median_reference(at_edge)[2] is False
    # One set's median beyond it: the ensemble (40 values) takes over.
    ref = _ref(shift_set=3, shift=iqr)
    e_med, e_iqr, ens = h.median_reference(ref)
    values = list(ref["tpu"]) + [v for row in ref["ulp"] for v in row]
    assert ens is True and len(values) == 40
    assert (e_med, e_iqr) == pytest.approx(h._quartiles(values))
    assert e_med != med


def test_hold_holds_every_run_paired_and_config_6_at_one_seed():
    """`hold` gives every metric a paired line with a verdict; one seed's
    miss beyond its bound fails the metric's paired hold; config 6's one
    run is held per seed."""
    ref = h.REFERENCE["1"]["ate"]
    runs = [{"ate": v} for v in ref["tpu"]]
    lines = dict((m, ok) for m, _, ok in h.hold("1", runs))
    assert lines == {"ate": True, "ate/paired": True}
    # A miss beyond the bound about both of the reference's compiles.
    runs[5] = {"ate": min(ref["tpu"][5], ref["nofma"][5])
               - 1.01 * h.paired_bound(ref["spread"][5])}
    assert dict((m, ok) for m, _, ok in h.hold("1", runs))["ate/paired"] is False
    six = {m: r["tpu"][0] for m, r in h.REFERENCE["6"].items()}
    out = h.hold("6", [six])
    assert all(ok is True for m, _, ok in out if m.endswith("/paired"))
    assert {m for m, _, _ in out} >= {f"{m}/paired" for m in h.REFERENCE["6"]}


def test_reference_has_a_spread_for_every_held_metric_at_every_seed_the_port_runs():
    for c, metrics in h.REFERENCE.items():
        for m, ref in metrics.items():
            n = h.SEEDS[c]
            assert len(ref["spread"]) >= n and len(ref["ulp"]) >= n, (c, m)
            for d in range(n):
                assert len(ref["ulp"][d]) == 4, (c, m, d)
                assert ref["spread"][d] >= 0
                # The spread is the largest one-ulp move at seed d (the
                # table's values rounded to 1e-6, the spread to 3 digits).
                move = max(abs(v - ref["tpu"][d]) for v in ref["ulp"][d])
                assert abs(ref["spread"][d] - move) <= 1.5e-6 + 5e-3 * move, (c, m, d)


def test_seeds_equal_the_reference_seeds_wherever_medians_are_held():
    for c, metrics in h.REFERENCE.items():
        if h.SEEDS[c] > 1:
            for m, ref in metrics.items():
                assert len(ref["tpu"]) == h.SEEDS[c] == 8, (c, m)
    assert h.SEEDS["6"] == 1
    assert np.isclose(h.PAIRED_FACTOR, 2.0) and h.PAIRED_FLOOR == 1e-4


# (draw 0, no-FMA, port, held, the compiles that hold it): spread 2^-11, so
# the bound is 2^-10; binary fractions keep every distance exact.
EITHER_CASES = [
    (0.5, 0.5 + 2.0 ** -7, 0.5 + 2.0 ** -10, True, "draw 0"),
    (0.5, 0.5 + 2.0 ** -7, 0.5 + 2.0 ** -7 - 2.0 ** -10, True, "no-FMA"),
    (0.5, 0.5 + 2.0 ** -7, 0.5 + 2.0 ** -7 + 2.0 ** -10, True, "no-FMA"),
    (0.5, 0.5 + 2.0 ** -10, 0.5 + 2.0 ** -11, True, "draw 0 and no-FMA"),
    # Out: beyond the bound about each compile (its width is kept).
    (0.5, 0.5 + 2.0 ** -7, 0.5 + 2.0 ** -7 + 2.0 ** -10 + 2.0 ** -30, False, "neither"),
    (0.5, 0.5 + 2.0 ** -7, 0.5 + 2.0 ** -8, False, "neither"),
    (0.5, 0.5 + 2.0 ** -7, 0.5 - 2.0 ** -10 - 2.0 ** -30, False, "neither"),
]


@pytest.mark.parametrize("ref0,nofma,port,held,which", EITHER_CASES)
def test_paired_rule_holds_about_either_compile_and_fails_beyond_both(ref0, nofma, port, held,
                                                                     which):
    table = dict(tpu=(ref0,), ulp=((ref0,) * 4,), spread=(2.0 ** -11,), nofma=(nofma,))
    name, line, ok = h.paired("ate", [port], table)
    assert ok is held
    assert f": {which} over seeds 0-0" in line
    # By draw 0 alone (the rule before the no-FMA runs) it holds only where draw 0 does.
    assert ("paired within" in h.draw0_verdict("ate", [port], table)) is ("draw 0" in which)


@pytest.mark.parametrize("port,held", [(4, True), (5, True), (6, True), (7, True), (3, False),
                                       (8, False)])
def test_paired_count_rule_is_the_range_of_the_six_runs(port, held):
    # Seed 0's six runs: draw 0 and the one-ulp draws 5, the no-FMA run 7;
    # seed 1's span 4-6 by its one-ulp draws.
    table = dict(tpu=(5, 5), ulp=((5, 5, 5, 5), (4, 6, 5, 5)), spread=(0, 1), nofma=(7, 5))
    assert h.paired("n_loops", [port, 5], table)[2] is (held and port != 4)
    assert h.paired("n_loops", [5, port], table)[2] is (held and port != 7)
    # The count over the seeds: within the range of draw 0's and the no-FMA runs.
    assert h.reference_range(table) == (5, 7)


def _union_ref():
    """Draw 0 at 1..8 (IQR 3.5), no-FMA runs at 1..7 and 10.5: the union's
    range [1, 10.5], widened by draw 0's IQR to [-2.5, 14]."""
    tpu = tuple(float(v) for v in range(1, 9))
    return dict(tpu=tpu, ulp=tuple((v,) * 4 for v in tpu), spread=(0.0,) * 8,
                nofma=tpu[:7] + (10.5,))


@pytest.mark.parametrize("top,held", [(14.0, True), (14.0 + 2.0 ** -20, False), (11.5, True)])
def test_range_is_the_union_of_draw_0_and_no_fma_widened_by_draw_0_iqr(monkeypatch, top, held):
    ref = _union_ref()
    monkeypatch.setitem(h.REFERENCE, "union", {"ate": ref})
    # Port runs: draw 0's values but the largest moved to `top` (median kept).
    runs = [{"ate": v} for v in ref["tpu"][:7] + (top,)]
    ok = dict((m, ok) for m, _, ok in h.hold("union", runs))["ate"]
    assert ok is held
    # By draw 0 alone the range would end at 8 + 3.5 = 11.5.
    assert ("range within" in h.draw0_verdict("ate", [r["ate"] for r in runs], ref)) is (
        top <= 11.5)


def test_reference_has_a_no_fma_value_for_every_metric_at_every_seed_with_a_spread():
    for c, metrics in h.REFERENCE.items():
        for m, ref in metrics.items():
            assert len(ref["nofma"]) == len(ref["spread"]) == len(spread.ENSEMBLE_SEEDS[c]), (c, m)
            assert all(np.isfinite(v) for v in ref["nofma"]), (c, m)
            if m in h.DISCRETE:
                assert all(float(v).is_integer() for v in ref["nofma"]), (c, m)


def _host_has_fma() -> bool:
    try:
        with open("/proc/cpuinfo") as fh:
            return any(line.startswith("flags") and " fma " in f" {line.split(':', 1)[1]} "
                       for line in fh)
    except OSError:
        return False


@pytest.mark.skipif(not _host_has_fma(), reason="the host has no FMA instructions, so XLA's "
                    "default and no-FMA compiles agree")
def test_compile_probe_fuses_by_default_and_rounds_each_product_without_fma():
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            "import eval_reference_spread as e; print(e.compile_probe())")
    flags = os.environ.get("XLA_FLAGS", "")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], cwd=SCRIPTS, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": f"{flags} {extra}".strip()})
        for name, extra in (("default", ""), ("nofma", spread.NOFMA_FLAG))}
    got = {name: p.communicate(timeout=120)[0].strip().splitlines()[-1]
           for name, p in procs.items()}
    assert got == {"default": "fused", "nofma": "two-rounding"}

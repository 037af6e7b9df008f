"""The port's EVAL holds (`scripts/torch_eval_configs.py`) on fixed
numbers, without running an engine: the paired rule at each seed
(|port_d - reference_d| <= max(2 s_d, 1e-4), s_d the reference's one-ulp
spread at seed d), the count rule (within the reference's five runs at the
seed), the median rule's one exception (the reference's ensemble where one
of its own one-ulp seed sets fails draw 0's median hold), and the table
`REFERENCE` against the seeds the harness runs.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_eval_configs as h  # noqa: E402

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
    runs[5] = {"ate": ref["tpu"][5] + 1.01 * h.paired_bound(ref["spread"][5])}
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

"""The readings that the limits of a cell's correctness check are set from:
for each seed, one pass of the cell's window (its traffic at its size,
from its set-up), then the check's numbers for the program and for
the control (the reference one precision lower, in the program's place).

    python3 vio_bench/calibrate.py --workload sift_b512 --seeds 1,2,3

One JSON line per seed, then the largest program reading and the smallest
control reading of each number. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vio_bench import check, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    c = run.load_cell(a.workload)
    rows = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        out = run.run_cell(c, seed, 0.0, False, device=a.device, control=True)
        row = {"seed": seed, "correct": out["correct"], "failed": out["failed"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": out["control"], "metrics": out["metrics"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "lower": {k: max(r["program"][k] for r in rows) for k in check.NUMBERS},
        "upper": {k: min(r["control"][k] for r in rows) for k in check.NUMBERS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

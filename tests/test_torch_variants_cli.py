"""The port's CLI with the step options it refused before: --oriented,
--photometric, --gauge marg and --gauge oldest2 (with --imu-scale: SLAM
mode, the window VI-BA in the step, as users pass --gauge), each on
--synthetic 14 against the JAX CLI with the same flags on the same
sequence.

The two CLIs draw the same RANSAC stream, but their default bf16
pipelines round differently, so their rows are held as tests/test_torch_cli.py holds
the default run: the port's ATE under 0.5 m and within 0.05 m of the
reference's (measured when written, port / reference: --oriented 0.0077 /
0.0077 m, --photometric 0.0474 / 0.0428, --gauge marg and oldest2 0.0424 /
0.0505: within 14 frames GT-free the VI-BA is not engaged, so the two
gauges give the same rows). The engine each run builds carries the flag's
setting.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vislam_tpu_torch.engine as tengine
from vislam_tpu_torch import cli
from vislam_tpu_torch.eval import read_trajectory_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

FLAGS = {
    # flags, the config field each sets (section, field, value)
    "oriented": (["--oriented"], ("frontend", "oriented", True)),
    "photometric": (["--photometric"], ("engine", "photometric_refine", True)),
    "gauge_marg": (["--imu-scale", "--gauge", "marg"], ("backend", "online_gauge", "marg")),
    "gauge_oldest2": (["--imu-scale", "--gauge", "oldest2"],
                      ("backend", "online_gauge", "oldest2")),
}


def _ate(stdout):
    return float(re.search(r"ATE RMSE \(unaligned\): ([0-9.]+) m", stdout).group(1))


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_cli_step_option_against_reference_cli(tmp_path, monkeypatch, capsys, name):
    flags, (section, field, value) = FLAGS[name]
    built = []
    init = tengine.VIOEngine.__init__

    def spy(self, calib, cfg, *a, **k):
        built.append(cfg)
        init(self, calib, cfg, *a, **k)

    monkeypatch.setattr(tengine.VIOEngine, "__init__", spy)
    out = str(tmp_path / "t.csv")
    assert cli.main(["--cpu", "--synthetic", "14", "--output", out, *flags]) == 0
    a_t = _ate(capsys.readouterr().out)
    assert built and all(getattr(getattr(c, section), field) == value for c in built)
    if name.startswith("gauge"):
        assert all(c.backend.vi_factors and c.backend.refine_in_step for c in built)
    rows = read_trajectory_csv(out)
    assert len(rows["frame"]) == 13 and np.isfinite(rows["est_p"]).all()

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO}
    j = subprocess.run([sys.executable, "-m", "vislam_tpu.cli", "--cpu", "--synthetic", "14",
                        "--output", str(tmp_path / "j.csv"), *flags],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert j.returncode == 0, j.stderr[-3000:]
    a_j = _ate(j.stdout)
    assert a_t < 0.5 and abs(a_t - a_j) < 0.05, (a_t, a_j)

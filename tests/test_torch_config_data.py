"""vislam_tpu_torch against vislam_tpu: configuration, synthetic data,
camera model, metrics, state conversion, and the rule that the port imports
neither jax nor the reference package."""

import dataclasses
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.calib import camera_model as jcam
from vislam_tpu.data import SyntheticConfig as JSynCfg
from vislam_tpu.data import make_synthetic_sequence as j_make_seq
from vislam_tpu.eval import ate_rmse as j_ate, rpe_rmse as j_rpe
from vislam_tpu.utils.config import SystemConfig as JSystemConfig
from vislam_tpu_torch.calib import camera_model as tcam
from vislam_tpu_torch.data import SyntheticConfig as TSynCfg
from vislam_tpu_torch.data import make_synthetic_sequence as t_make_seq
from vislam_tpu_torch.eval import ate_rmse as t_ate, rpe_rmse as t_rpe
from vislam_tpu_torch.utils.config import SystemConfig as TSystemConfig

torch.set_num_threads(2)


def test_config_defaults_equal_reference():
    assert dataclasses.asdict(TSystemConfig()) == dataclasses.asdict(JSystemConfig())
    t, j = TSystemConfig().frontend, JSystemConfig().frontend
    assert t.max_keypoints == j.max_keypoints == 768
    assert t.kp_per_cell_by_level == j.kp_per_cell_by_level
    assert t.desc_dim == j.desc_dim


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_sequence_byte_identical(seed):
    kw = dict(n_frames=3, n_landmarks=120, seed=seed, gyro_noise=0.01, accel_noise=0.05)
    a = j_make_seq(JSynCfg(**kw))
    b = t_make_seq(TSynCfg(**kw))
    for key in ("images", "imu_gyro", "imu_accel", "gt_pos", "gt_vel", "gt_quat",
                "gt_rpy", "t_cam_ns", "imu_t_ns", "landmarks"):
        assert a[key].dtype == b[key].dtype, key
        assert a[key].tobytes() == b[key].tobytes(), key
    assert dataclasses.asdict(a["calib"]).keys() == dataclasses.asdict(b["calib"]).keys()
    assert (a["calib"].fx, a["calib"].cx, a["calib"].width) == \
        (b["calib"].fx, b["calib"].cx, b["calib"].width)


def test_camera_model_matches_reference(rng):
    # f32 round-off: the same formulas on the same float32 inputs.
    dist = (-0.28, 0.07, 2e-4, 1.8e-5)
    xn = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    X = np.concatenate([xn * 5.0, np.full((64, 1), 5.0, np.float32)], -1)
    uv = rng.uniform(0, 700, (64, 2)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcam.distort_normalized(torch.from_numpy(xn), dist).numpy(),
        np.asarray(jcam.distort_normalized(jnp.asarray(xn), dist)), **tol)
    np.testing.assert_allclose(
        tcam.undistort_normalized(torch.from_numpy(xn), dist).numpy(),
        np.asarray(jcam.undistort_normalized(jnp.asarray(xn), dist)), **tol)
    np.testing.assert_allclose(
        tcam.project_points(torch.from_numpy(X), 458.0, 457.0, 367.0, 248.0, dist).numpy(),
        np.asarray(jcam.project_points(jnp.asarray(X), 458.0, 457.0, 367.0, 248.0, dist)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tcam.unproject_pixels(torch.from_numpy(uv), 458.0, 457.0, 367.0, 248.0).numpy(),
        np.asarray(jcam.unproject_pixels(jnp.asarray(uv), 458.0, 457.0, 367.0, 248.0)),
        **tol)


def test_metrics_match_reference(rng):
    est = rng.normal(size=(30, 3))
    gt = est + rng.normal(scale=0.05, size=(30, 3))
    for align in (False, True):
        assert t_ate(est, gt, align=align) == pytest.approx(j_ate(est, gt, align=align),
                                                            rel=1e-12)
    assert t_rpe(est, gt) == pytest.approx(j_rpe(est, gt), rel=1e-12)


def test_port_imports_neither_jax_nor_reference(tmp_path):
    """Import every module of the port, the map backend's, the step
    options' (photometric refine, adversarial imagery), the distributed
    paths', the debugging switches' and the evaluation layer's (runner,
    matchability, viz) included, and the port's EVAL harness
    (scripts/torch_eval_configs.py), in a fresh interpreter in which `jax`,
    `vislam_tpu`, `cv2` and `ml_dtypes` cannot be imported at all (the
    card's machine has none of them); none of it imports matplotlib (viz
    imports it only to draw). A kernel module comes first (the kernels
    import `frontend.pyramid`, the import cycle a subpackage's exports could
    close); then every subpackage's `__all__` resolves, also by a star
    import, and no compiler (nvcc, g++) was started: kernels build at their
    first launch."""
    script = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "vislam_tpu", "cv2", "ml_dtypes"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, REPO)
        import os, subprocess
        started, popen = [], subprocess.Popen.__init__

        def record(self, args, *a, **k):
            started.append(os.path.basename(str(args[0] if isinstance(args, list) else args)))
            popen(self, args, *a, **k)

        subprocess.Popen.__init__ = record
        import vislam_tpu_torch.ops.harris_kernel
        import vislam_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(vislam_tpu_torch.__path__,
                                                       "vislam_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        packages = [n for n in names if hasattr(sys.modules[n], "__path__")]
        assert len(packages) == 12, packages
        for n in packages:
            exported = sys.modules[n].__all__
            assert exported and all(getattr(sys.modules[n], e) is not None for e in exported), n
            space = {}
            exec(f"from {n} import *", space)
            assert set(exported) <= set(space), n
        compilers = [c for c in started if c.split()[0] in ("nvcc", "g++", "c++", "gcc", "cc")]
        assert not compilers, started
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "vislam_tpu", "cv2", "ml_dtypes")]
        assert not bad, bad
        assert len(names) >= 20, names
        # The map backend's modules and the step options' among them.
        for m in ("lie.se3", "lie.sim3", "backend.pose_graph", "backend.sim3_graph",
                  "backend.pnp", "backend.loop", "backend.triangulate",
                  "backend.trajectory_opt", "backend.reloc", "backend.mapio",
                  "backend.photometric", "data.adversarial", "parallel.mesh",
                  "parallel.dist_ba", "parallel.batch_runner", "utils.debug",
                  "eval.runner", "eval.matchability", "viz", "viz.plots", "viz.live"):
            assert "vislam_tpu_torch." + m in names, m
        spec = importlib.util.spec_from_file_location(
            "torch_eval_configs", sys.path[0] + "/scripts/torch_eval_configs.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "vislam_tpu", "cv2", "ml_dtypes",
                                      "matplotlib")]
        assert not bad, bad
        print("OK", len(names))
    """)
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = script.replace("REPO", repr(repo))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env={**os.environ, "PYTHONPATH": repo},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")

"""The port's CLI, `python -m vislam_tpu_torch.cli`, in subprocesses on the
CPU (--cpu), on the reference CLI tests' fixtures: a synthetic sequence
(against the JAX CLI on the same sequence), an EuRoC fixture with an
OpenCV-XML calibration (host loop and --scan), a distorted one, a KITTI
one, checkpoint and resume; the map flags (loop correction against the
reference's backend and CLI, map save, load and relocalization); the
distributed window BA (--dist-ba, gloo ranks on the CPU); and the viz
flags (--plot, --live-viz).
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence, write_euroc_fixture
from vislam_tpu_torch import cli
from vislam_tpu_torch.eval import read_trajectory_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args, cpu=True, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-m", module, *(["--cpu"] if cpu else []), *args],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)
    return r


def _port(args, **kw):
    r = _run("vislam_tpu_torch.cli", args, **kw)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _ate(stdout):
    return float(re.search(r"ATE RMSE \(unaligned\): ([0-9.]+) m", stdout).group(1))


def _xml(path, calib, dist=None):
    """An OpenCV-XML calibration written by cv2, as the reference's tests write it."""
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("camera_matrix", calib.K)
    fs.write("distortion_coefficients", np.asarray(calib.dist if dist is None else dist))
    fs.write("image_width", calib.width)
    fs.write("image_height", calib.height)
    fs.write("camera_rate", 20.0)
    fs.write("imu_rate", 200.0)
    fs.release()
    return path


@pytest.fixture(scope="module")
def synthetic14(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("syn") / "t.csv")
    return _port(["--synthetic", "14", "--output", out]), read_trajectory_csv(out)


def test_cli_synthetic_against_reference_cli(tmp_path, synthetic14):
    """13 frames, finite; ATE < 0.5 m and within 0.05 m of the JAX CLI's on
    the same sequence (both draw the reference's RANSAC stream; the default
    bf16 pipelines round differently, tests/test_torch_engine.py)."""
    r, data = synthetic14
    assert len(data["frame"]) == 13 and np.isfinite(data["est_p"]).all()
    assert "processed 13 frames" in r.stdout and "drain" in r.stdout
    j = _run("vislam_tpu.cli", ["--synthetic", "14", "--output", str(tmp_path / "j.csv")])
    assert j.returncode == 0, j.stderr[-3000:]
    a_t, a_j = _ate(r.stdout), _ate(j.stdout)
    assert a_t < 0.5 and abs(a_t - a_j) < 0.05, (a_t, a_j)


def test_cli_resume_equals_uninterrupted_run(tmp_path, synthetic14):
    """Checkpointed at frame 7 (and its keyframes), resumed to 14: the tail
    equals the uninterrupted run's rows (positions within 1e-5 m, keyframes
    equal; the same draws from the restored counter)."""
    ck = str(tmp_path / "state.npz")
    _port(["--synthetic", "8", "--output", str(tmp_path / "a.csv"), "--checkpoint", ck])
    assert os.path.exists(ck)
    r = _port(["--synthetic", "14", "--output", str(tmp_path / "b.csv"), "--checkpoint", ck,
               "--resume"])
    assert "resumed from" in r.stdout
    full, part = synthetic14[1], read_trajectory_csv(str(tmp_path / "b.csv"))
    n = len(part["frame"])
    assert n == 14 - 8
    np.testing.assert_array_equal(part["frame"], full["frame"][-n:])
    np.testing.assert_array_equal(part["is_kf"], full["is_kf"][-n:])
    np.testing.assert_allclose(part["est_p"], full["est_p"][-n:], atol=1e-5, rtol=0)


def test_cli_fetch_every_frame_gives_the_same_rows(tmp_path, monkeypatch, synthetic14):
    """The host loop fetching every frame (PIPE_BURST = 1) gives the rows of
    the default bursts: the burst only sets when the host reads results
    (positions within 1e-5 m, keyframes equal)."""
    monkeypatch.setattr(cli, "PIPE_BURST", 1)
    out = str(tmp_path / "b1.csv")
    assert cli.main(["--cpu", "--synthetic", "14", "--output", out]) == 0
    a, b = read_trajectory_csv(out), synthetic14[1]
    np.testing.assert_array_equal(a["frame"], b["frame"])
    np.testing.assert_array_equal(a["is_kf"], b["is_kf"])
    np.testing.assert_allclose(a["est_p"], b["est_p"], atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def euroc(tmp_path_factory):
    from vislam_tpu.data.synthetic import synthetic_calib

    root = tmp_path_factory.mktemp("euroc")
    write_euroc_fixture(str(root / "seq"), SyntheticConfig(n_frames=18, n_landmarks=150,
                                                           seed=5), static_prefix_s=1.0)
    return str(root / "seq"), _xml(str(root / "calib.xml"), synthetic_calib())


def test_cli_euroc_fixture_host_loop_and_scan(tmp_path, euroc):
    """The EuRoC layout with an XML calibration: the host loop reads the
    frames through the prefetch thread and the scan stages them; both give
    the same rows (the same step on the same inputs: positions within
    1e-5 m, keyframes equal), finite, with GT."""
    ds, xml = euroc
    out_h, out_s = str(tmp_path / "h.csv"), str(tmp_path / "s.csv")
    h = _port(["--dataset", ds, "--calibration", xml, "--output", out_h])
    _port(["--dataset", ds, "--calibration", xml, "--output", out_s, "--scan"])
    assert "frame read" in h.stdout and _ate(h.stdout) < 0.5
    a, b = read_trajectory_csv(out_h), read_trajectory_csv(out_s)
    assert len(a["frame"]) >= 10 and np.isfinite(a["est_p"]).all()
    assert np.isfinite(a["gt_p"]).all()
    np.testing.assert_array_equal(b["frame"], a["frame"])
    np.testing.assert_array_equal(b["is_kf"], a["is_kf"])
    np.testing.assert_allclose(b["est_p"], a["est_p"], atol=1e-5, rtol=0)


def test_cli_undistorts_distorted_fixture(tmp_path):
    """tests/test_cli_distorted.py's fixture: radial distortion synthesised
    on the images, the distortion in the XML; the port remaps every frame
    and tracks (position error < 0.6 m, that test's bound)."""
    import cv2
    import jax.numpy as jnp

    from vislam_tpu.calib.camera_model import remap_bilinear, undistort_normalized
    from vislam_tpu.data.synthetic import synthetic_calib

    ds = str(tmp_path / "seq")
    write_euroc_fixture(ds, SyntheticConfig(n_frames=18, n_landmarks=200, seed=33),
                        static_prefix_s=0.5)
    clean = synthetic_calib()
    dist = (-0.15, 0.03, 0.0, 0.0)
    vv, uu = np.meshgrid(np.arange(clean.height), np.arange(clean.width), indexing="ij")
    xd = np.stack([(uu - clean.cx) / clean.fx, (vv - clean.cy) / clean.fy], -1)
    xn = np.asarray(undistort_normalized(jnp.asarray(xd, jnp.float32), dist, iters=10))
    maps = np.stack([xn[..., 0] * clean.fx + clean.cx, xn[..., 1] * clean.fy + clean.cy],
                    -1).astype(np.float32)
    cam = os.path.join(ds, "mav0", "cam0", "data")
    for name in sorted(os.listdir(cam)):
        img = cv2.imread(os.path.join(cam, name), cv2.IMREAD_GRAYSCALE)
        warped = np.asarray(remap_bilinear(jnp.asarray(img, jnp.float32), jnp.asarray(maps)))
        cv2.imwrite(os.path.join(cam, name), np.clip(warped, 0, 255).astype(np.uint8))
    xml = _xml(str(tmp_path / "calib.xml"), clean, dist)
    out = str(tmp_path / "t.csv")
    r = _port(["--dataset", ds, "--calibration", xml, "--output", out])
    assert "undistort" in r.stdout
    data = read_trajectory_csv(out)
    assert np.isfinite(data["est_p"]).all()
    assert np.linalg.norm(data["est_p"] - data["gt_p"], axis=-1).max() < 0.6


def test_cli_kitti_fixture(tmp_path):
    """tests/test_cli_kitti.py's fixture (KITTI layout, no IMU, vision-only
    rotation by force): 14 rows, finite estimates and GT."""
    import cv2
    from scipy.spatial.transform import Rotation as Rsp

    from vislam_tpu.data.synthetic import synthetic_calib

    seq = make_synthetic_sequence(SyntheticConfig(n_frames=16, n_landmarks=200, seed=15))
    root = tmp_path / "kitti"
    img_dir = root / "sequences" / "00" / "image_0"
    os.makedirs(img_dir)
    os.makedirs(root / "poses")
    for i, img in enumerate(seq["images"]):
        cv2.imwrite(str(img_dir / f"{i:06d}.png"), img)
    np.savetxt(str(root / "sequences" / "00" / "times.txt"), np.arange(16) * 0.05, fmt="%.6f")
    with open(root / "poses" / "00.txt", "w") as f:
        for q, p in zip(seq["gt_quat"], seq["gt_pos"]):
            R = Rsp.from_quat(np.roll(q, -1)).as_matrix()
            f.write(" ".join(f"{x:.9f}" for x in np.hstack([R, p[:, None]]).reshape(-1)) + "\n")
    xml = _xml(str(tmp_path / "calib.xml"), synthetic_calib())
    out = str(tmp_path / "t.csv")
    _port(["--dataset", str(root), "--format", "kitti", "--sequence", "00",
           "--calibration", xml, "--output", out])
    data = read_trajectory_csv(out)
    assert len(data["frame"]) == 14
    assert np.isfinite(data["est_p"]).all() and np.isfinite(data["gt_p"]).all()


def _loops(stdout):
    """The [(a, b, inliers), ...] of the "loop closures:" line."""
    line = re.search(r"^loop closures: (.*)$", stdout, re.M)
    assert line, stdout[-2000:]
    return ast.literal_eval(line.group(1))


def _same_loops(a, b):
    """Equal pairs in the same order; inliers within 2 (the match twin and
    XLA can flip a near-tied ratio test, measured 0-1)."""
    assert [x[:2] for x in a] == [y[:2] for y in b] and a, (a, b)
    assert all(abs(x[2] - y[2]) <= 2 for x, y in zip(a, b)), (a, b)


@pytest.fixture(scope="module")
def loop86(tmp_path_factory):
    """--synthetic 86 (the path revisits its start at frame 80) with
    --loop-correct and --save-map, run at once by the reference CLI and by
    the port (SE(3) and --loop-sim3): {name: (stdout, csv, map)}."""
    d = tmp_path_factory.mktemp("loop")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2", "PYTHONPATH": REPO}
    runs = {"reference": ("vislam_tpu.cli", []), "se3": ("vislam_tpu_torch.cli", []),
            "sim3": ("vislam_tpu_torch.cli", ["--loop-sim3"])}
    procs = {}
    for name, (module, extra) in runs.items():
        out, mp = str(d / f"{name}.csv"), str(d / f"{name}.npz")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", module, "--cpu", "--synthetic", "86", "--loop-correct",
             *extra, "--save-map", mp, "--output", out], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE), out, mp)
    done = {}
    for name, (proc, out, mp) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        done[name] = (stdout, out, mp)
    return done


@pytest.mark.parametrize("graph", ["se3", "sim3"])
def test_cli_loop_correct_against_reference(loop86, graph):
    """The port CLI's loop line and corrected keyframe rows are the
    reference backend's (`correct_trajectory`, SE(3) or Sim(3)) on the
    archive the port CLI saved: the same loops, rows within 1e-3 m. The
    reference CLI on the same sequence also closes loops, its ATE within
    0.05 m of the port's (the RANSAC draws differ, so the archives do)."""
    from vislam_tpu.backend.mapio import load_map
    from vislam_tpu.backend.trajectory_opt import correct_trajectory
    from vislam_tpu.data.synthetic import synthetic_calib

    stdout, out, mp = loop86[graph]
    c = synthetic_calib()
    archive = load_map(mp)
    p_ref, _, info = correct_trajectory(archive, c.fx, c.fy, c.cx, c.cy,
                                        use_sim3=graph == "sim3")
    _same_loops(_loops(stdout), info["loops"])
    data = read_trajectory_csv(out)
    by_frame = {k.frame_index: i for i, k in enumerate(archive)}
    kf = [n for n, f in enumerate(data["frame"]) if int(f) in by_frame]
    assert len(kf) == len(archive) > 10
    np.testing.assert_allclose(data["est_p"][kf],
                               p_ref[[by_frame[int(data["frame"][n])] for n in kf]],
                               atol=1e-3, rtol=0)
    ref = loop86["reference"][0]
    assert _loops(ref) and abs(_ate(stdout) - _ate(ref)) < 0.05


def test_cli_loop_correct_on_reference_map(loop86, tmp_path):
    """The port CLI, no frame stepped, on the map the reference CLI saved
    (--load-map): the reference CLI's own loop line."""
    r = _port(["--synthetic", "1", "--load-map", loop86["reference"][2], "--loop-correct",
               "--output", str(tmp_path / "t.csv")])
    assert "loaded map: " in r.stdout
    _same_loops(_loops(r.stdout), _loops(loop86["reference"][0]))


def test_cli_save_then_load_map_and_reloc(tmp_path):
    """tests/test_mapio.py:45 for the port: --save-map in one run (a map the
    reference's load_map reads), --load-map --reloc in the next."""
    from vislam_tpu.backend.mapio import load_map

    mp = str(tmp_path / "m.npz")
    r1 = _port(["--synthetic", "16", "--output", str(tmp_path / "a.csv"), "--save-map", mp])
    assert "map saved: " in r1.stdout
    assert len(load_map(mp)) >= 2
    r2 = _port(["--synthetic", "16", "--output", str(tmp_path / "b.csv"), "--load-map", mp,
                "--reloc"])
    assert f"loaded map: {len(load_map(mp))} keyframes" in r2.stdout
    assert np.isfinite(read_trajectory_csv(str(tmp_path / "b.csv"))["est_p"]).all()


def test_cli_relocalizes_with_the_head_image(tmp_path, monkeypatch):
    """--reloc during an outage (every frame's matches forced to 0; an
    archive of two keyframes loaded): from the 3rd frame on, each processed
    row's attempt extracts features from the newest dispatched image (the
    head of its burst of 4), the image the head state is re-anchored with,
    as the divergence guard does; the reference's dataset branch passes the
    drained frame's image instead (its cli.py:642)."""
    import vislam_tpu_torch.backend.reloc as reloc
    import vislam_tpu_torch.engine as engine
    import vislam_tpu_torch.frontend.features as features
    from vislam_tpu_torch.backend.mapio import save_map
    from vislam_tpu_torch.backend.trajectory_opt import KeyframeRecord
    from vislam_tpu_torch.data import SyntheticConfig as TSynCfg
    from vislam_tpu_torch.data import make_synthetic_sequence as t_make_seq

    rng = np.random.default_rng(0)
    mp = str(tmp_path / "m.npz")
    save_map(mp, [KeyframeRecord(i, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                 rng.uniform(0, 400, (8, 2)).astype(np.float32),
                                 rng.normal(size=(8, 128)).astype(np.float32),
                                 np.ones(8, bool)) for i in range(2)])
    seen = []
    unpack, extract = engine.unpack_host_result, features.extract_features

    def extract_spy(image, *args, **kw):
        seen.append(image.to(torch.uint8).numpy())
        return extract(image, *args, **kw)

    monkeypatch.setattr(engine, "unpack_host_result",
                        lambda row: unpack(row)._replace(num_matches=0))
    monkeypatch.setattr(features, "extract_features", extract_spy)
    monkeypatch.setattr(reloc, "attempt_relocalization",
                        lambda *a, **k: reloc.RelocResult(False, None, None, -1, 0, float("inf")))
    assert cli.main(["--cpu", "--synthetic", "9", "--reloc", "--load-map", mp,
                     "--output", str(tmp_path / "t.csv")]) == 0
    images = t_make_seq(TSynCfg(n_frames=9, n_landmarks=300, seed=0))["images"]
    # Rows 1-4 (head 4) and 5-8 (head 8); attempts from the 3rd row on.
    assert len(seen) == 6
    for got, head in zip(seen, [4, 4, 8, 8, 8, 8]):
        np.testing.assert_array_equal(got, images[head])


VIZ = {
    # flag: the PNG suffixes it writes
    "--plot": ("_traj.png", "_state.png"),
    "--live-viz": ("_live.png",),
}


@pytest.mark.parametrize("flag", sorted(VIZ))
def test_cli_viz_flags_write_their_pngs(tmp_path, capsys, flag):
    """--plot PREFIX and --live-viz PREFIX on --synthetic 12 (the
    reference's `viz/`): exit 0, their PNGs written (no temporary left
    behind by the live snapshot's atomic rewrite), the line that names
    them printed, and the trajectory as without the flag."""
    prefix = str(tmp_path / "v")
    out, plain = str(tmp_path / "t.csv"), str(tmp_path / "plain.csv")
    assert cli.main(["--cpu", "--synthetic", "12", "--output", out, flag, prefix]) == 0
    text = capsys.readouterr().out
    for suffix in VIZ[flag]:
        assert os.path.getsize(prefix + suffix) > 10000, suffix
    assert not os.path.exists(prefix + "_live.tmp.png")
    assert ("plots written to" if flag == "--plot" else "live snapshot:") in text
    assert cli.main(["--cpu", "--synthetic", "12", "--output", plain]) == 0
    np.testing.assert_array_equal(read_trajectory_csv(out)["est_p"],
                                  read_trajectory_csv(plain)["est_p"])


def test_cli_dist_ba(tmp_path, capsys):
    """--dist-ba 4 after a 24-frame SLAM-mode run (tests/test_cli.py's
    counterpart): exit 0, the backend line (gloo: --cpu), the reference's
    mesh line, the refine accepted, every rank on the CPU, and the
    trajectory finite."""
    out = str(tmp_path / "traj.csv")
    report = {}
    assert cli.main(["--cpu", "--synthetic", "24", "--imu-scale", "--vi-ba", "--dist-ba", "4",
                     "--output", out], report=report) == 0
    text = capsys.readouterr().out
    assert "distributed window BA: backend gloo, 4 ranks on cpu, cpu, cpu, cpu" in text
    assert "distributed window BA (mesh=4 devices)" in text
    dist = report["dist_ba"]
    assert dist["info"]["accepted"] and dist["devices"] == ["cpu"] * 4
    assert dist["info"]["final_cost"] < dist["info"]["initial_cost"]
    assert np.isfinite(read_trajectory_csv(out)["est_p"]).all()


def test_cli_dist_ba_under_torchrun_needs_its_world_size(monkeypatch):
    """Under torchrun (WORLD_SIZE set) --dist-ba N must name the group's
    size: a usage error before any work otherwise."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        cli.main(["--cpu", "--synthetic", "5", "--dist-ba", "4"])
    assert e.value.code == 2


def test_cli_argument_errors_and_no_card(tmp_path):
    """--resume without --checkpoint and a run without a sequence are
    usage errors; without --cpu the CLI asks for the card and, where there
    is none, exits non-zero with the engine's message (nothing falls back)."""
    for args in (["--cpu", "--synthetic", "5", "--resume"], ["--cpu"]):
        with pytest.raises(SystemExit) as e:
            cli.main(args)
        assert e.value.code == 2
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would use it")
    r = _run("vislam_tpu_torch.cli", ["--synthetic", "5", "--output", str(tmp_path / "t.csv")],
             cpu=False)
    assert r.returncode == 1 and "no CUDA device is available" in r.stderr
    assert not os.path.exists(tmp_path / "t.csv")

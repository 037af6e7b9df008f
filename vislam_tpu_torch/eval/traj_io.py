"""Trajectory files (port of `vislam_tpu/eval/traj_io.py`, numpy, copied):
the 29-column CSV with its header line (frame, timestamp, keyframe flag,
estimated position, RPY, quaternion, velocity, then the ground-truth
counterparts) and the TUM format (`timestamp tx ty tz qx qy qz qw`). Both
writers produce byte for byte the reference's files for the same rows.
"""

from __future__ import annotations

import numpy as np

HEADER = (
    "#frame,t_ns,is_kf,"
    "est_px,est_py,est_pz,est_roll,est_pitch,est_yaw,"
    "est_qw,est_qx,est_qy,est_qz,est_vx,est_vy,est_vz,"
    "gt_px,gt_py,gt_pz,gt_roll,gt_pitch,gt_yaw,"
    "gt_qw,gt_qx,gt_qy,gt_qz,gt_vx,gt_vy,gt_vz"
)


def write_trajectory_csv(path: str, rows) -> None:
    """rows: iterable of dicts with keys frame, t_ns, is_kf, est_p (3,),
    est_rpy (3,), est_q (4,), est_v (3,), gt_p, gt_rpy, gt_q, gt_v (or None)."""
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for r in rows:
            def vec(key, n):
                v = r.get(key)
                if v is None:
                    return [float("nan")] * n
                return [float(x) for x in np.asarray(v).reshape(-1)[:n]]

            vals = (
                [int(r["frame"]), int(r.get("t_ns", 0)), int(bool(r.get("is_kf", False)))]
                + vec("est_p", 3) + vec("est_rpy", 3) + vec("est_q", 4) + vec("est_v", 3)
                + vec("gt_p", 3) + vec("gt_rpy", 3) + vec("gt_q", 4) + vec("gt_v", 3)
            )
            f.write(",".join(str(v) for v in vals) + "\n")


def read_trajectory_csv(path: str) -> dict:
    """Read back into a dict of arrays keyed by column group."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim == 1:
        data = data[None, :]
    return {
        "frame": data[:, 0].astype(int),
        "t_ns": data[:, 1].astype(np.int64),
        "is_kf": data[:, 2].astype(bool),
        "est_p": data[:, 3:6],
        "est_rpy": data[:, 6:9],
        "est_q": data[:, 9:13],
        "est_v": data[:, 13:16],
        "gt_p": data[:, 16:19],
        "gt_rpy": data[:, 19:22],
        "gt_q": data[:, 22:26],
        "gt_v": data[:, 26:29],
    }


def write_trajectory_tum(path: str, rows) -> None:
    """TUM trajectory format: `timestamp tx ty tz qx qy qz qw` per line
    (timestamps in seconds), what the standard evaluation toolchains (evo,
    the TUM scripts) read."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for r in rows:
            p = np.asarray(r["est_p"], np.float64).reshape(-1)
            q = np.asarray(r["est_q"], np.float64).reshape(-1)  # wxyz
            t = float(r.get("t_ns", 0)) * 1e-9
            f.write(f"{t:.9f} {p[0]} {p[1]} {p[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]}\n")


def read_trajectory_tum(path: str):
    """Read a TUM-format trajectory -> dict(t (N,), p (N,3), q_wxyz (N,4))."""
    ts, ps, qs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            ps.append(v[1:4])
            qs.append([v[7], v[4], v[5], v[6]])  # xyzw -> wxyz
    return {"t": np.asarray(ts), "p": np.asarray(ps), "q_wxyz": np.asarray(qs)}

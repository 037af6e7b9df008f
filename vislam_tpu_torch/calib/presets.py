"""Calibration presets for the EuRoC, KITTI and TUM datasets, and OpenCV's
XML calibration files (port of `vislam_tpu/calib/presets.py`).

`load_opencv_xml` parses OpenCV's FileStorage XML with `xml.etree`: the
root `<opencv_storage>`, matrices (`type_id="opencv-matrix"` with
rows/cols/dt/data, or `"opencv-nd-matrix"` with sizes/dt/data, as OpenCV
writes a 1-D array) and plain scalars. `write_opencv_xml` writes the fields
the loader reads in that format.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from vislam_tpu_torch.calib.camera_model import CameraCalib

# EuRoC MAV cam0 <-> body (IMU) extrinsic, from the dataset's sensor.yaml T_BS.
_EUROC_T_BODY_CAM = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def euroc_calib() -> CameraCalib:
    """EuRoC MAV cam0 (MH/V sequences), 752x480 radtan."""
    return CameraCalib(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
        width=752, height=480,
        T_body_cam=_EUROC_T_BODY_CAM,
        rate_cam_hz=20.0, rate_imu_hz=200.0,
    )


def kitti_calib() -> CameraCalib:
    """KITTI odometry gray left, sequences 00-02 (rectified: no distortion)."""
    return CameraCalib(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        dist=(0.0, 0.0, 0.0, 0.0),
        width=1241, height=376,
        rate_cam_hz=10.0, rate_imu_hz=100.0,
    )


def tum_calib() -> CameraCalib:
    """TUM RGB-D freiburg1 RGB camera."""
    return CameraCalib(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        dist=(0.262383, -0.953104, -0.005358, 0.002628),
        width=640, height=480,
        rate_cam_hz=30.0, rate_imu_hz=0.0,
    )


def _node_value(node):
    """A FileStorage node: a matrix -> float64 array, else a float (None if
    the text is not a number)."""
    kind = node.get("type_id")
    if kind in ("opencv-matrix", "opencv-nd-matrix"):
        data = np.array([float(x) for x in node.findtext("data", "").split()], np.float64)
        if kind == "opencv-matrix":
            shape = (int(node.findtext("rows")), int(node.findtext("cols")))
        else:
            shape = tuple(int(x) for x in node.findtext("sizes").split())
        if data.size != int(np.prod(shape)):
            raise ValueError(f"{node.tag}: {data.size} values for shape {shape}")
        return data.reshape(shape)
    try:
        return float((node.text or "").strip())
    except ValueError:
        return None


def load_opencv_xml(path: str) -> CameraCalib:
    """Load an OpenCV-XML calibration file: camera matrix, distortion, image
    size, the imu2cam0 extrinsic and the rates; an absent field takes the
    reference's default (752x480, identity extrinsic, 20 / 200 Hz, no
    distortion). The camera matrix is required."""
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise ValueError(f"{path}: not an OpenCV XML file ({e})") from None
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: root element is <{root.tag}>, not <opencv_storage>")
    fields = {child.tag: _node_value(child) for child in root}

    def mat(name):
        v = fields.get(name)
        return v if isinstance(v, np.ndarray) else None

    def real(name, default):
        v = fields.get(name)
        return default if v is None or isinstance(v, np.ndarray) else v

    K = mat("camera_matrix")
    if K is None:
        raise ValueError(f"{path}: no camera_matrix")
    dist = mat("distortion_coefficients")
    T = mat("imu2cam0")
    return CameraCalib(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        dist=tuple(dist.flatten()[:4]) if dist is not None else (0.0,) * 4,
        width=int(real("image_width", 752)), height=int(real("image_height", 480)),
        T_body_cam=np.eye(4) if T is None else np.asarray(T, np.float64),
        rate_cam_hz=float(real("camera_rate", 20.0)),
        rate_imu_hz=float(real("imu_rate", 200.0)),
    )


def write_opencv_xml(path: str, calib: CameraCalib) -> None:
    """Write `calib` as an OpenCV-XML calibration file that
    `load_opencv_xml` (and OpenCV's FileStorage) reads back."""

    def matrix(name, a):
        a = np.asarray(a, np.float64)
        vals = " ".join(repr(float(x)) for x in a.reshape(-1))
        return (f'<{name} type_id="opencv-matrix">\n  <rows>{a.shape[0]}</rows>\n'
                f"  <cols>{a.shape[1]}</cols>\n  <dt>d</dt>\n  <data>\n    {vals}</data></{name}>\n")

    text = ('<?xml version="1.0"?>\n<opencv_storage>\n'
            + matrix("camera_matrix", calib.K)
            + matrix("distortion_coefficients", np.asarray(calib.dist)[:, None])
            + f"<image_width>{int(calib.width)}</image_width>\n"
            + f"<image_height>{int(calib.height)}</image_height>\n"
            + f"<camera_rate>{float(calib.rate_cam_hz)!r}</camera_rate>\n"
            + f"<imu_rate>{float(calib.rate_imu_hz)!r}</imu_rate>\n"
            + matrix("imu2cam0", calib.T_body_cam)
            + "</opencv_storage>\n")
    with open(path, "w") as f:
        f.write(text)

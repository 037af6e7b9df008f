"""Camera model, undistortion and calibration presets (port of vislam_tpu.calib)."""

from vislam_tpu_torch.calib.camera_model import (
    CameraCalib,
    compute_undistort_maps,
    distort_normalized,
    project_points,
    remap_bilinear,
    scale_calib,
    undistort_image,
    undistort_normalized,
    unproject_pixels,
)
from vislam_tpu_torch.calib.presets import (
    euroc_calib,
    kitti_calib,
    load_opencv_xml,
    tum_calib,
    write_opencv_xml,
)

__all__ = [
    "CameraCalib",
    "project_points",
    "unproject_pixels",
    "distort_normalized",
    "undistort_normalized",
    "compute_undistort_maps",
    "remap_bilinear",
    "undistort_image",
    "scale_calib",
    "euroc_calib",
    "kitti_calib",
    "tum_calib",
    "load_opencv_xml",
    "write_opencv_xml",
]

"""Camera model, undistortion and calibration presets (port of vislam_tpu.calib)."""

from vislam_tpu_torch.calib.camera_model import (
    CameraCalib,
    compute_undistort_maps,
    remap_bilinear,
    scale_calib,
    undistort_image,
)
from vislam_tpu_torch.calib.presets import (
    euroc_calib,
    kitti_calib,
    load_opencv_xml,
    tum_calib,
    write_opencv_xml,
)

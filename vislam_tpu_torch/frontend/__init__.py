"""Detection, description, matching, two-view pose (port of vislam_tpu.frontend).

The reference's exports resolve on first use (PEP 562): the kernels in
`ops/` import `frontend.pyramid`, and an eager import of `detect` here
would import `ops.harris_kernel` back while it is half initialised.
"""

import importlib

_EXPORTS = {
    "build_pyramid": "pyramid",
    "scharr_gradients": "pyramid",
    "gaussian_blur": "pyramid",
    "detect_keypoints": "detect",
    "harris_response": "detect",
    "Keypoints": "detect",
    "describe_keypoints": "descriptor",
    "match_descriptors": "match",
    "Matches": "match",
    "rotation_compensated_disparity": "pose",
    "ransac_translation": "pose",
    "epipolar_inlier_mask": "pose",
    "Features": "features",
    "extract_features": "features",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value

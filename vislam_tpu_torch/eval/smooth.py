"""Retroactive bootstrap smoothing of a GT-free trajectory (port of
`vislam_tpu/eval/smooth.py`, numpy, copied).

A cold start corrupts the emitted trajectory until the VI alignment
re-anchors the live estimate; the already emitted prefix keeps the corrupt
positions. The shadow trajectory (engine/state.py) is continuous from the
origin and consistently scaled, so once the metric scale is known the
prefix is rewritten as

    p_corrected(t) = origin + s * (shadow(t) - shadow_origin)

only on runs where a re-anchor fired (bootstrap_applies > 0).
"""

from __future__ import annotations

import numpy as np


def smooth_bootstrap_prefix(poses, shadows, applies, origin, shadow_origin,
                            min_fit_frames: int = 6):
    """Correct the pre-alignment prefix of an emitted trajectory.

    poses:   (N, 3) per-frame live position estimates, as published.
    shadows: (N, 3) per-frame shadow positions (state.shadow_p_wc).
    applies: (N,) int — state.bootstrap_applies after each frame.
    origin / shadow_origin: (3,) state anchors (equal at initialization).

    Returns (N, 3): frames before the LAST re-anchor replaced by the
    scaled shadow; everything from the re-anchor on is already the live
    corrected estimate and passes through unchanged. If no re-anchor ever
    fired (warm run), returns poses unchanged.
    """
    poses = np.asarray(poses, np.float64)
    shadows = np.asarray(shadows, np.float64)
    applies = np.asarray(applies)
    if applies.size == 0 or int(applies[-1]) == 0:
        return poses
    # Boundary: the last frame whose step incremented the apply counter.
    prev = np.concatenate([[0], applies[:-1]])
    bounds = np.nonzero(applies > prev)[0]
    b = int(bounds[-1])
    origin = np.asarray(origin, np.float64)
    sh0 = np.asarray(shadow_origin, np.float64)

    # Metric scale: least-squares fit of the POST-boundary (trusted,
    # re-anchored) segment against the shadow. Falls back to the boundary
    # frame's own ratio when the tail is too short for a stable fit.
    p_c = poses[b:] - origin
    s_c = shadows[b:] - sh0
    den = float(np.sum(s_c * s_c))
    if poses.shape[0] - b >= min_fit_frames and den > 1e-12:
        s = float(np.sum(p_c * s_c)) / den
    else:
        d = float(np.linalg.norm(shadows[b] - sh0))
        s = float(np.linalg.norm(poses[b] - origin)) / max(d, 1e-9)
    out = poses.copy()
    out[:b] = origin + s * (shadows[:b] - sh0)
    return out

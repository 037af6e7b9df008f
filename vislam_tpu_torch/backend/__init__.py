"""Triangulation, the window bundle adjustments, photometric alignment and
the map backend: pose graphs (SE(3), Sim(3)), loop detection, PnP,
relocalization and keyframe maps (port of vislam_tpu.backend)."""

from vislam_tpu_torch.backend.triangulate import triangulate_dlt, triangulate_midpoint
from vislam_tpu_torch.backend.ba import (
    BAProblem,
    BAState,
    build_normal_equations,
    bundle_adjust,
    reprojection_residuals,
    schur_solve,
)
from vislam_tpu_torch.backend.photometric import PhotoResult, photometric_align
from vislam_tpu_torch.backend.pose_graph import (
    PoseGraph,
    odometry_edges,
    optimize_pose_graph,
    pose_graph_residuals,
)
from vislam_tpu_torch.backend.loop import (
    detect_loop_candidates,
    global_descriptors,
    verify_loop,
)
from vislam_tpu_torch.backend.pnp import PnPResult, pnp_gn
from vislam_tpu_torch.backend.sim3_graph import (
    Sim3Graph,
    optimize_sim3_graph,
    sim3_graph_residuals,
    sim3_odometry_edges,
)
from vislam_tpu_torch.backend.trajectory_opt import KeyframeRecord, correct_trajectory

__all__ = [
    "triangulate_midpoint",
    "triangulate_dlt",
    "BAProblem",
    "BAState",
    "bundle_adjust",
    "reprojection_residuals",
    "build_normal_equations",
    "schur_solve",
    "photometric_align",
    "PhotoResult",
    "PoseGraph",
    "optimize_pose_graph",
    "pose_graph_residuals",
    "odometry_edges",
    "global_descriptors",
    "detect_loop_candidates",
    "verify_loop",
    "pnp_gn",
    "Sim3Graph",
    "optimize_sim3_graph",
    "sim3_graph_residuals",
    "sim3_odometry_edges",
    "PnPResult",
    "KeyframeRecord",
    "correct_trajectory",
]

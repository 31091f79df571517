"""Geometry / SfM layer: SE(3) math, two-view estimation, triangulation,
pose graphs, bundle adjustment, odometry, trajectory metrics — the port of
``sift_tpu/geometry`` as plain functions on tensors."""

from sift_tpu_torch.geometry.ba import BAProblem, BAState, lm_optimize
from sift_tpu_torch.geometry.posegraph import (IncrementalPoseGraph,
                                               PoseGraph, edge_residuals)
from sift_tpu_torch.geometry.twoview import (TwoViewResult, eight_point,
                                             pixels_to_normalized,
                                             ransac_essential, recover_pose,
                                             sampson_error, triangulate)

__all__ = [
    "BAProblem", "BAState", "lm_optimize",
    "IncrementalPoseGraph", "PoseGraph", "edge_residuals",
    "TwoViewResult", "eight_point", "pixels_to_normalized",
    "ransac_essential", "recover_pose", "sampson_error", "triangulate",
]

"""Keypoint refinement — the single-octave stage contract.

Counterpart of ``sift_tpu/ops/refine.py``: ``refine_keypoints`` is the
per-stage entry of the golden-checkpoint replay (perf/replay.py
run_adjust_pts, the capability of the reference's
HostInterface::runAdjustPts), a name for the one Newton implementation in
ops/refine_dense.py.
"""

from __future__ import annotations

from sift_tpu_torch.ops.refine_dense import (RefinedKeypoints,
                                             refine_keypoints_dense)

__all__ = ["RefinedKeypoints", "refine_keypoints"]

refine_keypoints = refine_keypoints_dense

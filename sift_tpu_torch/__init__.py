"""sift_tpu_torch — the PyTorch/CUDA port of ``sift_tpu``.

Same capabilities, sub-package layout and public layouts as the JAX
package beside it (image ``[H, W]`` f32 0..255, keypoint fields
``[num_features]``, descriptors ``[num_features, 128]`` uint8, matches
``[Q]`` int32 with -1), written as plain functions on tensors with an
explicit ``device``.  The kernels — four on the detect+compute path, the
per-keypoint window copy of the non-fused stages, three window-loading
schemes of an experiment — are hand-written CUDA C++ for sm_90a
(``csrc/``), built with nvcc at first use and loaded with ctypes; each has
a plain PyTorch version beside it that runs for CPU tensors.  The package
imports ``torch`` and ``numpy`` only.
"""

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core.types import Keypoints, SiftResult, build_plan
from sift_tpu_torch.pipeline.detector import SiftDetector, build_detect_fn
from sift_tpu_torch.pipeline.matcher import match_brute_force, match_pairs

__version__ = "0.1.0"

__all__ = [
    "SiftConfig", "Keypoints", "SiftResult", "build_plan",
    "SiftDetector", "build_detect_fn",
    "match_brute_force", "match_pairs",
]

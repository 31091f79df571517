"""Configuration for the PyTorch/CUDA SIFT pipeline.

Counterpart of ``sift_tpu/config.py`` (same fields and defaults, so one
config describes the same detector in both packages); the TPU
``gather_impl`` knob becomes ``kernel_impl``.  The config is a frozen,
hashable dataclass.  Equivalent capability to the reference's
``CudaSiftConfig`` (sift_cuda/types/CudaSiftConfig.hh:3-14).

Unlike the reference (where ``upscale=true`` is documented broken,
CudaSiftConfig.hh:12-13), the upscale path here works and is used by the
OpenCV-parity tests (OpenCV SIFT always operates on a 2x-upscaled base image).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

# Algorithm constants, same contract as the reference
# (sift_cuda/sift_func/SiftOps.cuh:7-13).
SIFT_FIXPT_SCALE = 1.0
SIFT_IMG_BORDER = 5
SIFT_MAX_INTERP_STEPS = 5
SIFT_INIT_SIGMA = 0.5
SIFT_ORI_SIG_FCTR = 1.5
SIFT_ORI_RADIUS = 3.0 * SIFT_ORI_SIG_FCTR
SIFT_DESCR_SCL_FCTR = 3.0
SIFT_ORI_PEAK_RATIO = 0.8
SIFT_ORI_HIST_BINS = 36
SIFT_DESCR_WIDTH = 4
SIFT_DESCR_HIST_BINS = 8
SIFT_INT_DESCR_FCTR = 512.0
DESCRIPTOR_DIM = 128


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Static configuration of a SIFT detector instance.

    ``width``/``height`` are the input image dimensions (all frames processed
    by one detector share them, as in the reference's single-preallocation
    contract, extract_and_match_example.cc:57-64).
    """

    width: int
    height: int
    num_features: int = 5000
    num_octave_layers: int = 3
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6
    upscale: bool = False

    # --- knobs with no reference equivalent ---
    # Where orientation-histogram gradients are read from.  The reference
    # reads them from the DoG pyramid (interface/Detector.cu:489), which
    # deviates from OpenCV; "gaussian" matches OpenCV and is the default.
    orientation_source: str = "gaussian"
    # Sub-pixel final coordinates and parabolic orientation interpolation.
    # OpenCV has both; the reference drops both (SiftOps.cu:200-203,359-371).
    subpixel: bool = True
    interpolate_orientation: bool = True
    # Gaussian kernel support: size = round(truncate*sigma + 1) | 1.
    # 6.0 matches the reference (utils/GaussianUtils.cc:8,40); OpenCV's
    # GaussianBlur on f32 uses 8.0.  Default 8.0 (OpenCV is the oracle).
    kernel_truncate: float = 8.0
    # Octave downsampling: "nearest" decimation with floor-halved dims
    # (OpenCV buildGaussianPyramid: INTER_NEAREST at size/2) or "bilinear"
    # with round-halved dims (the reference's resize_cuda at
    # interface/Detector.cu:282-291, image_func/Resize.cu:26-63).
    downsample: str = "nearest"
    # Per-octave candidate capacity; None -> heuristic in SiftPlan.
    max_candidates_per_octave: Optional[int] = None
    # Pyramid blur implementation: "matmul" (composed banded operators as
    # dense matrix products) or "conv" (the reference's sequential per-layer
    # chain of separable 1-D convolutions, ops/pyramid.py).
    blur_impl: str = "matmul"
    # Lowe ratio applied to *squared* distances, matching the reference's
    # in-kernel hardcoded test (sift_func/Match.cu:171-175).
    match_ratio: float = 0.8
    # Which version of the hand-written kernels (record field, slab copies,
    # orientation and descriptor histograms, window copy) runs: "cuda" (the
    # CUDA C++ kernels; the tensors must be on a CUDA device), "torch" (each
    # kernel's plain PyTorch version), or "auto" (cuda on a CUDA device,
    # torch on a CPU device).
    kernel_impl: str = "auto"
    # Storage dtype of the dense Newton record field (the pipeline's
    # largest buffer).  "float32" is bit-exact; "bfloat16" halves it (and
    # its HBM write traffic) at <= 2^-9 relative error on sub-pixel
    # offsets (flag/decision channels are small integers — exact);
    # "auto" (default) keeps float32 below 1 MP and bfloat16 at/above
    # (memory parity at 1920x1200, no change at the flagship 752x480).
    refine_record_dtype: str = "auto"
    # Descriptor storage dtype.  "uint8": 0..255-quantized descriptors are
    # stored as one byte each (4x less result memory/transfer) and the
    # matcher runs its Gram matmul in bf16 — bit-identical match indices
    # (every value/product is exact; see pipeline/matcher.py).  The
    # counterpart of the reference's half-precision descriptor storage
    # (types/KeyPoint.cuh:27, SiftOps.cu:617-622).  Applies only to the
    # integer "opencv" quantization; the continuous "reference" mode
    # always stores float32.
    descriptor_dtype: str = "uint8"

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("Image width or height not set.")
        if self.orientation_source not in ("gaussian", "dog"):
            raise ValueError("orientation_source must be 'gaussian' or 'dog'")
        if self.blur_impl not in ("matmul", "conv"):
            raise ValueError("blur_impl must be 'matmul' or 'conv'")
        if self.downsample not in ("nearest", "bilinear"):
            raise ValueError("downsample must be 'nearest' or 'bilinear'")
        if self.kernel_impl not in ("auto", "cuda", "torch"):
            raise ValueError("kernel_impl must be 'auto', 'cuda' or "
                             "'torch'")
        if self.descriptor_dtype not in ("uint8", "float32"):
            raise ValueError("descriptor_dtype must be 'uint8' or "
                             "'float32'")
        if self.refine_record_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError("refine_record_dtype must be 'auto', "
                             "'float32' or 'bfloat16'")

    @property
    def num_octaves(self) -> int:
        """Octave count, the reference formula (interface/Detector.hh:27):
        round(log2(min(2W, 2H)) - 2) + 1."""
        m = min(self.width * 2, self.height * 2)
        return int(round(math.log(float(m)) / math.log(2.0) - 2.0)) + 1

    @property
    def base_width(self) -> int:
        return self.width * 2 if self.upscale else self.width

    @property
    def base_height(self) -> int:
        return self.height * 2 if self.upscale else self.height

    @property
    def num_gauss_layers(self) -> int:
        return self.num_octave_layers + 3

    @property
    def num_dog_layers(self) -> int:
        return self.num_octave_layers + 2

    @property
    def peak_threshold(self) -> float:
        """First-pass |DoG| threshold (interface/Detector.cu:366):
        floor(0.5 * contrast / L * 255 * FIXPT_SCALE)."""
        return math.floor(
            0.5 * self.contrast_threshold / self.num_octave_layers * 255.0
            * SIFT_FIXPT_SCALE
        )

"""Record-field kernel: Gaussian octave -> DoG -> 3x3x3 extrema mask ->
Newton record field, one pass.

Counterpart of ``sift_tpu/kernels/fused_detect.py``
(``detect_records_pallas``).  The CUDA kernel is
``csrc/fused_detect.cu``; ``detect_records_plain`` beside it is the same
function in plain PyTorch (ops/peaks.peak_mask +
ops/refine_dense.record_fields + ops/records.pack_record_channels).  The
wrapper ``detect_records_cuda`` launches the kernel or raises; the plain
version serves CPU tensors and explicit ``kernel_impl="torch"`` runs.

Input: one octave ``[NL, h, w]`` f32 at its natural shape, any h, w >= 1.
Output: ``[3, NL-3, h, w]`` f32, PLANE-major (channels A/B/C, then record
layers 1..NL-3).  Reads at x+-1 / y+-1 are clamped to the image in both
versions; the 1-px rim is unused by contract, and the peak bit is masked
to ``[border, size - border)``.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.kernels import build

# Launch counts: ``launches`` rises by one where the wrapper launches the
# CUDA kernel and nowhere else; ``plain_calls`` counts the plain version.
launches = {"detect_records": 0}
plain_calls = {"detect_records": 0}


def detect_records_plain(gauss_oct: torch.Tensor, threshold: float,
                         border: int, edge_threshold: float,
                         contrast_threshold: float,
                         octave_layers: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    from sift_tpu_torch.ops.peaks import clamp_pad, peak_mask
    from sift_tpu_torch.ops.records import pack_record_channels
    from sift_tpu_torch.ops.refine_dense import record_fields

    plain_calls["detect_records"] += 1
    dog = gauss_oct[1:] - gauss_oct[:-1]
    dogp = clamp_pad(dog)
    x0, x1, x2, contrast, flags = record_fields(dog, edge_threshold, dogp)
    mask, _ = peak_mask(dog, threshold, border, dogp)
    cok = contrast * octave_layers >= contrast_threshold
    a, b, c = pack_record_channels(x0, x1, x2, contrast, flags, mask, cok)
    return torch.stack([a, b, c], dim=0)               # [3, L, h, w]


def detect_records_cuda(gauss_oct: torch.Tensor, threshold: float,
                        border: int, edge_threshold: float,
                        contrast_threshold: float,
                        octave_layers: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``gauss_oct``'s device and current
    stream.  Raises on anything the kernel does not take; never falls
    back."""
    if not gauss_oct.is_cuda:
        raise ValueError("detect_records_cuda needs a CUDA tensor, got "
                         f"{gauss_oct.device}")
    if gauss_oct.dtype != torch.float32 or gauss_oct.dim() != 3:
        raise ValueError("gauss_oct must be [NL, h, w] float32, got "
                         f"{tuple(gauss_oct.shape)} {gauss_oct.dtype}")
    if not gauss_oct.is_contiguous():
        raise ValueError("gauss_oct must be contiguous")
    nl, h, w = gauss_oct.shape
    if nl < 4:
        raise ValueError(f"need at least 4 Gaussian layers, got {nl}")
    lib = build.load_library()
    out = torch.empty((3, nl - 3, h, w), dtype=torch.float32,
                      device=gauss_oct.device)
    et = float(edge_threshold)
    with torch.cuda.device(gauss_oct.device):
        rc = lib.sift_detect_records(
            gauss_oct.data_ptr(), out.data_ptr(), nl, h, w,
            float(threshold), int(border), et, (et + 1.0) * (et + 1.0),
            float(contrast_threshold), float(octave_layers),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "sift_detect_records")
    launches["detect_records"] += 1
    return out


def detect_records(gauss_oct: torch.Tensor, threshold: float, border: int,
                   edge_threshold: float, contrast_threshold: float,
                   octave_layers: int, impl: str = "auto") -> torch.Tensor:
    """The kernel's wrapper: a CUDA tensor launches the kernel (or
    raises); the plain version is taken for a CPU tensor, or on explicit
    ``impl="torch"``."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    fn = detect_records_cuda \
        if resolve_kernel_impl(impl, gauss_oct.device) == "cuda" \
        else detect_records_plain
    return fn(gauss_oct, threshold, border, edge_threshold,
              contrast_threshold, octave_layers)

"""Shifted slab copies in one pass.

Counterpart of ``sift_tpu/kernels/expand.py`` (``expand_lane_copies``).
The stacked pyramid's ``copies`` column-shifted replicas
(ops/flatpyr.stack_pyramid) are pure data movement.  The CUDA kernel is
``csrc/expand.cu``; ``expand_lane_copies_plain`` beside it is the same
function in plain PyTorch (a concatenation of shifted pads).  The wrapper
``expand_lane_copies_cuda`` launches the kernel or raises; the plain
version serves CPU tensors and explicit ``impl="torch"`` runs.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.kernels import build

LANES = 128

# Launch counts: ``launches`` rises by one where the wrapper launches the
# CUDA kernel and nowhere else; ``plain_calls`` counts the plain version.
launches = {"expand_lane_copies": 0}
plain_calls = {"expand_lane_copies": 0}


def _check_args(base: torch.Tensor, copies: int) -> None:
    if copies not in (2, 4):
        raise ValueError(f"copies must be 2 or 4, got {copies}")
    if base.dim() != 2 or base.dtype != torch.float32:
        raise ValueError("base must be [Hs, Ws] float32, got "
                         f"{tuple(base.shape)} {base.dtype}")
    if base.shape[1] % LANES:
        raise ValueError(f"slab width {base.shape[1]} is not a multiple "
                         f"of {LANES}")


def expand_lane_copies_plain(base: torch.Tensor, copies: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    plain_calls["expand_lane_copies"] += 1
    _check_args(base, copies)
    step = LANES // copies
    return torch.cat(
        [base] + [torch.nn.functional.pad(base[:, step * c:], (0, step * c))
                  for c in range(1, copies)], dim=0)


def expand_lane_copies_cuda(base: torch.Tensor, copies: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``base``'s device and current stream.
    Raises on anything the kernel does not take; never falls back."""
    if not base.is_cuda:
        raise ValueError("expand_lane_copies_cuda needs a CUDA tensor, got "
                         f"{base.device}")
    _check_args(base, copies)
    if not base.is_contiguous():
        raise ValueError("base must be contiguous")
    hs, ws = base.shape
    if hs > 65535:
        raise ValueError(f"slab of {hs} rows exceeds the kernel's grid")
    lib = build.load_library()
    out = torch.empty((copies * hs, ws), dtype=torch.float32,
                      device=base.device)
    with torch.cuda.device(base.device):
        rc = lib.sift_expand_lane_copies(
            base.data_ptr(), out.data_ptr(), hs, ws, copies, LANES // copies,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "sift_expand_lane_copies")
    launches["expand_lane_copies"] += 1
    return out


def expand_lane_copies(base: torch.Tensor, copies: int,
                       impl: str = "auto") -> torch.Tensor:
    """[Hs, Ws] -> [copies*Hs, Ws]; copy c is the base shifted LEFT by
    c * 128/copies columns with a zeroed tail.  A CUDA tensor launches the
    kernel (or raises); the plain version is taken for a CPU tensor, or on
    explicit ``impl="torch"``."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    fn = expand_lane_copies_cuda \
        if resolve_kernel_impl(impl, base.device) == "cuda" \
        else expand_lane_copies_plain
    return fn(base, copies)

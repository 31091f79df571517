"""Batched per-keypoint window extraction.

Counterpart of ``sift_tpu/kernels/window_gather.py`` (``window_rows``,
``window_origins``, ``gather_windows_pallas``).  The non-fused orientation
and descriptor stages read one aligned ``[rows, lanes]`` window per keypoint
out of a uniform-shape ``[L, Hp, Wp]`` gradient slab
(ops/flatpyr.PaddedPyramid).  The CUDA kernel is ``csrc/window_gather.cu``;
``gather_windows_plain`` beside it is the same function in plain PyTorch
(one advanced-indexing gather).  ``gather_windows_cuda`` launches the kernel
or raises; the plain version serves CPU tensors and explicit
``impl="torch"`` runs.

Window origins are aligned DOWN (rows to 8, columns to 128) and the window
is oversized so it still contains the patch and its 1-px gradient halo; it
is origin-shifted near edges, never clipped, and callers reconstruct exact
per-pixel offsets from the origins.  Elements outside the slab (a slab
smaller than one window) read as 0, as from a slab zero-padded to hold the
window.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.kernels import build

LANES = 256      # default window width: 128-aligned origin + 128 slack
SUBLANE = 8

# Launch counts: ``launches`` rises by one where the wrapper launches the
# CUDA kernel and nowhere else; ``plain_calls`` counts the plain version.
launches = {"gather_windows": 0}
plain_calls = {"gather_windows": 0}


def window_rows(radius: int) -> int:
    """Rows of a window that holds a patch of +-radius with a 1-px
    gradient halo; same value as the JAX package's (which adds 8-row
    alignment slack) so both packages size their windows alike."""
    need = 2 * (radius + 1) + 1 + (SUBLANE - 1)
    return -(-need // SUBLANE) * SUBLANE


def window_origins(padded_shape, layer_index, cy, cx, rows: int,
                   radius: int):
    """Aligned, clamped window origins: the [ys0:ys0+rows, xs0:xs0+256]
    window lies inside the slab (zero-padded up to one window where it is
    smaller) and contains the image-masked +-(radius+1) neighbourhood of
    (cy, cx).

    Requires slab dims aligned to (8, 128) (pad_pyramid guarantees this);
    then the clamp bounds are themselves aligned and clamping never loses
    edge coverage.  Returns (lidx, ys0, xs0) int32, ys0 % 8 == 0,
    xs0 % 128 == 0."""
    l, hp, wp = padded_shape
    hp = -(-max(hp, rows) // SUBLANE) * SUBLANE
    wp = -(-max(wp, LANES) // 128) * 128
    r = radius + 1
    ys0 = torch.div(cy - r, SUBLANE, rounding_mode="floor") * SUBLANE
    ys0 = torch.clamp(ys0, min=0, max=hp - rows).to(torch.int32)
    xs0 = torch.div(cx - r, 128, rounding_mode="floor") * 128
    xs0 = torch.clamp(xs0, min=0, max=wp - LANES).to(torch.int32)
    lidx = torch.clamp(layer_index, 0, l - 1).to(torch.int32)
    return lidx, ys0, xs0


def _check_args(values, lidx, ys0, xs0, rows: int, lanes: int) -> None:
    if values.dim() != 3 or values.dtype != torch.float32:
        raise ValueError("values must be [L, Hp, Wp] float32, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if rows <= 0 or rows % SUBLANE or lanes <= 0 or lanes % 128:
        raise ValueError(f"window {rows}x{lanes}: rows must be a multiple "
                         f"of {SUBLANE}, lanes of 128")
    k = lidx.shape[0]
    for name, t in (("lidx", lidx), ("ys0", ys0), ("xs0", xs0)):
        if t.shape != (k,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be [K] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != values.device:
            raise ValueError("all arguments must be on the slab's device")


def gather_windows_plain(values: torch.Tensor, lidx, ys0, xs0, rows: int,
                         lanes: int = LANES) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): one gather with
    broadcast index ranges; elements outside the slab are 0 and ``lidx``
    is clamped, exactly as the kernel does."""
    plain_calls["gather_windows"] += 1
    _check_args(values, lidx, ys0, xs0, rows, lanes)
    nl, hp, wp = values.shape
    dev = values.device
    y = ys0.to(torch.int64)[:, None] + torch.arange(rows, device=dev)
    x = xs0.to(torch.int64)[:, None] + torch.arange(lanes, device=dev)
    li = torch.clamp(lidx.to(torch.int64), 0, nl - 1)
    win = values[li[:, None, None],
                 torch.clamp(y, 0, hp - 1)[:, :, None],
                 torch.clamp(x, 0, wp - 1)[:, None, :]]
    inside = (((y >= 0) & (y < hp))[:, :, None]
              & ((x >= 0) & (x < wp))[:, None, :])
    return torch.where(inside, win, torch.zeros_like(win))


def gather_windows_cuda(values: torch.Tensor, lidx, ys0, xs0, rows: int,
                        lanes: int = LANES) -> torch.Tensor:
    """Launch the CUDA kernel on ``values``' device and current stream.
    Raises on anything the kernel does not take; never falls back."""
    if not values.is_cuda:
        raise ValueError("gather_windows_cuda needs a CUDA tensor, got "
                         f"{values.device}")
    _check_args(values, lidx, ys0, xs0, rows, lanes)
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned")
    nl, hp, wp = values.shape
    k = lidx.shape[0]
    lib = build.load_library()
    out = torch.empty((k, rows, lanes), dtype=torch.float32,
                      device=values.device)
    lidx, ys0, xs0 = lidx.contiguous(), ys0.contiguous(), xs0.contiguous()
    with torch.cuda.device(values.device):
        rc = lib.sift_gather_windows(
            values.data_ptr(), lidx.data_ptr(), ys0.data_ptr(),
            xs0.data_ptr(), out.data_ptr(), nl, hp, wp, k, rows, lanes,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "sift_gather_windows")
    launches["gather_windows"] += 1
    return out


def gather_windows(values: torch.Tensor, lidx, ys0, xs0, rows: int,
                   lanes: int = LANES, impl: str = "auto") -> torch.Tensor:
    """values [L, Hp, Wp] f32; lidx/ys0/xs0 [K] int32 aligned window
    origins (``window_origins``) -> [K, rows, lanes].  A CUDA tensor
    launches the kernel (or raises); the plain version is taken for a CPU
    tensor, or on explicit ``impl="torch"``."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    fn = gather_windows_cuda \
        if resolve_kernel_impl(impl, values.device) == "cuda" \
        else gather_windows_plain
    return fn(values, lidx, ys0, xs0, rows, lanes)

"""Row-stacked pyramid slab: per-keypoint windows from any octave/layer out
of ONE buffer.

Counterpart of ``sift_tpu/ops/flatpyr.py`` (``StackedPyramid``,
``stack_pyramid``, ``stacked_origins``).  Every kept (octave, layer) plane
at its natural height, concatenated over rows into one [Hs, Ws] slab, so
the orientation and descriptor kernels process keypoints of ALL octaves in
one launch each.

As in the JAX package the slab is replicated ``copies`` times with column
shifts (kernels/expand.expand_lane_copies), so that every patch lies
within the first 128/copies columns of a window whose origin is aligned
to 128 columns on one of the copies; the detector uses the JAX detector's
own copy count.  A CUDA block loads from any address, so a single-copy
slab (``copies=1``: no expansion, each window exactly at its patch
corner) serves the per-keypoint kernels just as well; the main path does
not use it yet.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch

from sift_tpu_torch.kernels.expand import LANES, expand_lane_copies

SUBLANE_ = 8


class StackedPyramid(NamedTuple):
    """Row-stacked pyramid (plane starts 8-row aligned; Ws = align128(W0)
    + 128 columns of slack so a 128-wide window starting at any image
    column stays inside a row), the whole slab repeated ``copies`` times,
    copy c shifted LEFT by c * 128/copies columns."""

    values: torch.Tensor   # [copies*Hs, Ws] f32
    row_off: torch.Tensor  # [O*D] i32 start row of plane octave*D + layer
    #                        (layers outside [layer_lo, layer_hi) clamped)
    height: torch.Tensor   # [O] i32 valid height per octave
    width: torch.Tensor    # [O] i32
    layers: int            # D (static; row_off is indexed with full-D lrel)
    copies: int            # shifted copy count (128 % copies == 0)
    copy_rows: int         # Hs — row stride between copies

    def octave_geometry(self, octave: torch.Tensor):
        o = octave.to(torch.int64)
        return self.height[o], self.width[o]


@functools.lru_cache(maxsize=256)
def _i32_table(vals: tuple, device: str) -> torch.Tensor:
    """Small static int32 table on ``device``, uploaded once (shapes are
    static per detector, so the per-frame path issues no host-to-device
    copy for it)."""
    return torch.as_tensor(np.array(vals, np.int32), device=device)


def window_lanes(copies: int, radius: int) -> int:
    """Columns of a window that holds a patch of +-``radius`` with its
    1-px gradient halo wherever ``stacked_origins`` may place it: the
    patch starts up to 128/copies - 1 columns into the window (at column
    0 on a single-copy slab)."""
    off_max = LANES // copies - 1 if copies > 1 else 0
    need = off_max + 2 * (radius + 1) + 1
    return -(-need // LANES) * LANES


def stack_pyramid(blocks: List[torch.Tensor], extra_rows: int = 0,
                  copies: int = 1, layer_lo: int = 0,
                  layer_hi: int = 0, impl: str = "auto") -> StackedPyramid:
    """blocks: per-octave [D, H_o, W_o], octave 0 largest.  ``extra_rows``:
    bottom margin >= the largest window row count, so windows that start
    inside the LAST plane stay in-bounds (reads past a plane's valid rows
    land in the next plane — garbage by contract, always masked by the
    consumers' bounds tests).  ``layer_lo/hi``: keep only planes
    [layer_lo, layer_hi) per octave (keypoints only ever reference
    Gaussian layers 1..L); out-of-range layer indices in row_off are
    clamped (invalid keypoints may carry them).  ``impl``: how the copies
    are expanded (kernels/expand.expand_lane_copies)."""
    d, h0, w0 = blocks[0].shape
    dev = blocks[0].device
    layer_hi = layer_hi or d
    nl = layer_hi - layer_lo
    if copies not in (1, 2, 4):
        raise ValueError(f"copies must be 1, 2 or 4, got {copies}")
    ws = -(-max(w0, 128) // 128) * 128 + 128
    slabs, offs, hs, wws = [], [], [], []
    row = 0
    for b in blocks:
        bd, h, w = b.shape
        ha = -(-h // 8) * 8
        for l in range(bd):
            lc = min(max(l, layer_lo), layer_hi - 1)
            offs.append(row + (lc - layer_lo) * ha)
        slabs.append(torch.nn.functional.pad(
            b[layer_lo:layer_hi], (0, ws - w, 0, ha - h)).reshape(nl * ha,
                                                                  ws))
        row += nl * ha
        hs.append(h)
        wws.append(w)
    pad = -(-extra_rows // 8) * 8 if extra_rows else 0
    if pad:
        slabs.append(torch.zeros((pad, ws), dtype=blocks[0].dtype,
                                 device=dev))
        row += pad
    base = torch.cat(slabs, dim=0)
    vals = expand_lane_copies(base, copies, impl) if copies > 1 else base
    i32 = lambda a: _i32_table(tuple(a), str(dev))
    return StackedPyramid(values=vals, row_off=i32(offs), height=i32(hs),
                          width=i32(wws), layers=d, copies=copies,
                          copy_rows=row)


def stacked_origins(src: StackedPyramid, octave, layer, cy, cx, radius):
    """Window origins on a stacked slab for the per-keypoint kernels.

    ``radius``: per-KEYPOINT patch radius (tensor or int).  On a
    single-copy slab the window starts exactly at the patch corner,
    ``(cy - radius - 1, cx - radius - 1)`` clamped to the image's top/left
    edge — no alignment.  On a 2/4-copy slab the origins are the JAX
    package's: rows aligned down to 8, columns to 128 on the copy that
    puts the patch within the first 128/copies columns.

    Returns (ys0, xs0, off, dy0, dx0): absolute window origins, the
    patch's column offset inside the window (0 on a single-copy slab), and
    the window[0, 0] offsets relative to the keypoint centre."""
    if not torch.is_tensor(radius):
        radius = torch.full_like(cy, int(radius))
    m = radius.to(torch.int32) + 1
    lrel = octave.to(torch.int64) * src.layers + layer.to(torch.int64)
    lrel = torch.clamp(lrel, 0, src.row_off.shape[0] - 1)
    base = src.row_off[lrel]
    xlo = torch.clamp(cx - m, min=0)
    if src.copies == 1:
        ys_rel = torch.clamp(cy - m, min=0)
        xs0 = xlo
        off = torch.zeros_like(xlo)
    else:
        ys_rel = torch.clamp(
            torch.div(cy - m, SUBLANE_, rounding_mode="floor") * SUBLANE_,
            min=0)
        step = 128 // src.copies
        q = torch.div(xlo, step, rounding_mode="floor")
        c = q % src.copies
        b = torch.div(q, src.copies, rounding_mode="floor")
        xs0 = b * 128
        off = xlo - (step * c + xs0)              # = xlo % step
        base = base + c * src.copy_rows
    return ((base + ys_rel).to(torch.int32), xs0.to(torch.int32),
            off.to(torch.int32), ys_rel - cy, (xlo - off) - cx)

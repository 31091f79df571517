"""Pyramid slabs: per-keypoint windows from any octave/layer out of ONE
buffer.

Counterpart of ``sift_tpu/ops/flatpyr.py``.  Two layouts:

* ``StackedPyramid`` (``stack_pyramid``, ``stacked_origins``): every kept
  (octave, layer) plane at its natural height, concatenated over rows into
  one [Hs, Ws] slab of RAW pixels, so the orientation and descriptor
  kernels process keypoints of ALL octaves in one launch each (the
  detector's default path);
* ``PaddedPyramid`` (``pad_pyramid``, ``shift_copies``,
  ``dense_gradients_*``, ``keypoint_window_*``): every octave embedded in a
  uniform [Hp, Wp] plane, stacked to [O*D, Hp, Wp], holding DENSE
  precomputed gradients; the non-fused orientation and descriptor stages
  copy one aligned window per keypoint out of it
  (kernels/window_gather.gather_windows).  The golden capture / replay
  stages and the detector's branch for large patch radii run on it.

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
import math
from typing import List, NamedTuple

import numpy as np
import torch

from sift_tpu_torch.kernels.expand import LANES, expand_lane_copies
from sift_tpu_torch.kernels.window_gather import (SUBLANE, gather_windows,
                                                  window_origins,
                                                  window_rows)


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
            torch.div(cy - m, SUBLANE, rounding_mode="floor") * SUBLANE,
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


# ---------------------------------------------------------------------------
# Uniform-shape padded pyramid and dense gradients (the non-fused stages)
# ---------------------------------------------------------------------------


class PaddedPyramid(NamedTuple):
    """Uniform-shape pyramid: every octave's [D, H_o, W_o] block embedded
    at the top-left of a [D, Hp, Wp] slab, stacked to [O*D, Hp, Wp].

    The uniform shape makes a per-keypoint window ONE aligned block copy.
    Out-of-octave padding pixels are garbage by contract; every consumer
    masks to [1, h_o-2] x [1, w_o-2]."""

    values: torch.Tensor   # [copies * O*D, Hp, Wp]
    height: torch.Tensor   # [O] i32 valid height per octave
    width: torch.Tensor    # [O] i32
    layers: int            # D (static)
    copies: int = 1        # column-shifted replicas (see shift_copies)

    def octave_geometry(self, octave: torch.Tensor):
        """Per-keypoint (h, w) for octave indices [K]."""
        o = octave.to(torch.int64)
        return self.height[o], self.width[o]


def pad_pyramid(blocks: List[torch.Tensor]) -> PaddedPyramid:
    """blocks: per-octave [D, H_o, W_o], octave 0 largest.  Slab dims are
    rounded up to (8, 128) so that aligned window origins
    (kernels/window_gather.window_origins) can always be clamped without
    losing edge coverage."""
    d, h0, w0 = blocks[0].shape
    hp = -(-max(h0, 8) // 8) * 8
    wp = -(-max(w0, 128) // 128) * 128
    slabs, hs, ws = [], [], []
    for b in blocks:
        _, h, w = b.shape
        slabs.append(torch.nn.functional.pad(b, (0, wp - w, 0, hp - h)))
        hs.append(h)
        ws.append(w)
    dev = str(blocks[0].device)
    return PaddedPyramid(values=torch.cat(slabs, dim=0),
                         height=_i32_table(tuple(hs), dev),
                         width=_i32_table(tuple(ws), dev), layers=d)


def shift_copies(p: PaddedPyramid, n: int = 4) -> PaddedPyramid:
    """Append column-shifted replicas of the slab (shift = 128/n columns
    apart).  With them a keypoint can always pick a copy whose aligned
    128-wide window contains its whole patch: windows shrink from 256 to
    128 columns, halving the window traffic and all downstream per-pixel
    work, at n times the slab memory.  A concatenation of shifted pads."""
    v = p.values
    step = 128 // n
    outs = [v] + [torch.nn.functional.pad(v[:, :, step * c:], (0, step * c))
                  for c in range(1, n)]
    return p._replace(values=torch.cat(outs, dim=0), copies=n)


def _gradients(b: torch.Tensor):
    """dx = I[y, x+1] - I[y, x-1]; dy = I[y-1, x] - I[y+1, x] (wrapping:
    the 1-px rim is garbage by contract); magnitude and orientation in
    degrees, [0, 360)."""
    dx = torch.roll(b, -1, dims=-1) - torch.roll(b, 1, dims=-1)
    dy = torch.roll(b, 1, dims=-2) - torch.roll(b, -1, dims=-2)
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx) * (180.0 / math.pi)
    return mag, torch.where(ori < 0, ori + 360.0, ori)


def dense_gradients_padded(p: PaddedPyramid):
    """Dense gradient magnitude/orientation on the padded stack (rim and
    padding pixels are garbage by contract).  Returns (mag, ori)
    pyramids."""
    mag, ori = _gradients(p.values)
    return p._replace(values=mag), p._replace(values=ori)


# 10-bit magnitude + 14-bit orientation packed into one float32:
# packed = mag_q * 16384 + ori_q, an integer <= 2^24 - 1 (exact in f32).
# Orientation gets the finer grain (0.022 deg): histogram-bin decisions are
# sensitive to it, while magnitude only weights sums.  Max gradient
# magnitude for 0..255 images is 2*255*sqrt(2) ~ 721.2.
_PACK_BINS = 16384.0
_PACK_MAG_SCALE = 1023.0 / 722.0


def dense_gradients_packed(p: PaddedPyramid) -> PaddedPyramid:
    """Packed dense gradients: ONE slab instead of (mag, ori), halving the
    per-keypoint window traffic of the descriptor stage.  Quantisation:
    mag to 0.71 absolute (of <= 722), ori to 0.022 deg.  ``torch.round``
    rounds half to even, like ``jnp.round``."""
    mag, ori = _gradients(p.values)
    mq = torch.clamp(torch.round(mag * _PACK_MAG_SCALE), 0.0, 1023.0)
    oq = torch.round(ori * (_PACK_BINS / 360.0))
    oq = torch.where(oq >= _PACK_BINS, oq - _PACK_BINS, oq)
    return p._replace(values=mq * _PACK_BINS + oq)


def unpack_gradients(packed: torch.Tensor):
    """Inverse of the packing: (mag, ori_degrees)."""
    mq = torch.floor(packed * (1.0 / _PACK_BINS))
    oq = packed - mq * _PACK_BINS
    return mq * (1.0 / _PACK_MAG_SCALE), oq * (360.0 / _PACK_BINS)


def dense_gradients(blocks: List[torch.Tensor]):
    """Per-octave dense gradient magnitude and orientation (degrees,
    [0, 360)) of every layer.  Border pixels (the 1-px rim) hold garbage
    and must be masked by consumers."""
    pairs = [_gradients(b) for b in blocks]
    return [m for m, _ in pairs], [o for _, o in pairs]


def keypoint_window_origins(src: PaddedPyramid, octave, layer, cy, cx,
                            radius: int):
    """Aligned window origins of keypoints at integer (cy, cx) in octave
    coordinates.  Returns (lidx, ys0, xs0, xs_abs, rows, lanes): the
    arguments of kernels/window_gather.gather_windows, and the absolute
    image column of window column 0 (on a shifted copy it differs from
    ``xs0`` by the copy's shift).  With shifted slab copies
    (shift_copies) lanes = 128, else 256."""
    rows = window_rows(radius)
    lrel = octave.to(torch.int32) * src.layers + layer.to(torch.int32)
    if src.copies == 1:
        li, ys0, xs0 = window_origins(src.values.shape, lrel, cy, cx, rows,
                                      radius)
        return li, ys0, xs0, xs0, rows, 256
    # Pick the shifted copy whose aligned 128-column window contains the
    # patch: absolute window start step*q with q = (cx - r - 1) // step
    # puts cx at column offset in [r+1, r+step] and the patch end at
    # <= 2(r+1)+step-1 <= 127 columns for r <= 47 (4 copies).
    floor_div = lambda a, b: torch.div(a, b, rounding_mode="floor")
    lanes = 128
    n_total = src.values.shape[0] // src.copies
    step = lanes // src.copies
    hp, wp = src.values.shape[-2:]
    m = radius + 1
    q = torch.clamp(floor_div(cx - m, step), min=0)
    copy = q % src.copies
    xs0 = torch.clamp(floor_div(q, src.copies) * lanes,
                      max=wp - lanes).to(torch.int32)
    li = (copy * n_total + lrel).to(torch.int32)
    ys0 = torch.clamp(
        floor_div(cy - m, SUBLANE) * SUBLANE, min=0,
        max=-(-max(hp, rows) // SUBLANE) * SUBLANE - rows).to(torch.int32)
    return li, ys0, xs0, xs0 + copy.to(torch.int32) * step, rows, lanes


def _keypoint_windows(src: PaddedPyramid, octave, layer, cy, cx,
                      radius: int, impl: str = "auto"):
    """One pyramid's per-keypoint windows with aligned origins.

    Returns (win, offy, offx): windows [K, rows, lanes] and the true
    per-pixel offsets from the keypoint centre, offy [K, rows] /
    offx [K, lanes] — the window is origin-shifted near edges, never
    clipped, so offsets are exact and consumer masks stay correct.
    ``impl``: which version of the window copy runs
    (kernels/window_gather)."""
    cy = cy.to(torch.int32)
    cx = cx.to(torch.int32)
    li, ys0, xs0, xs_abs, rows, lanes = keypoint_window_origins(
        src, octave, layer, cy, cx, radius)
    win = gather_windows(src.values, li, ys0, xs0, rows, lanes, impl)
    dev = cy.device
    ry = torch.arange(rows, dtype=torch.int32, device=dev)
    rx = torch.arange(lanes, dtype=torch.int32, device=dev)
    offy = ys0[:, None] + ry[None, :] - cy[:, None]
    offx = xs_abs[:, None] + rx[None, :] - cx[:, None]
    return win, offy, offx


def keypoint_window_packed(packed: PaddedPyramid, octave, layer, cy, cx,
                           radius: int, impl: str = "auto"):
    """Per-keypoint PACKED-gradient windows (ONE window copy) decoded.
    Returns (wm, wo, offy, offx) like keypoint_window_pair."""
    w, offy, offx = _keypoint_windows(packed, octave, layer, cy, cx, radius,
                                      impl)
    m, o = unpack_gradients(w)
    return m, o, offy, offx


def keypoint_window_pair(mag: PaddedPyramid, ori: PaddedPyramid, octave,
                         layer, cy, cx, radius: int, impl: str = "auto"):
    """Two-pyramid variant (separate mag/ori slabs): two window copies with
    shared origins."""
    wm, offy, offx = _keypoint_windows(mag, octave, layer, cy, cx, radius,
                                       impl)
    wo, _, _ = _keypoint_windows(ori, octave, layer, cy, cx, radius, impl)
    return wm, wo, offy, offx

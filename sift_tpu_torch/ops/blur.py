"""Separable Gaussian blur.

Counterpart of ``sift_tpu/ops/blur.py``, three implementations:

* ``blur_matmul`` — the blur as two dense matrix products with precomputed
  banded operators (core/gaussian.blur_operator), boundary handling baked
  into the operator, layers batched by broadcasting.  These are large
  plain matrix products and go to ``torch.matmul`` in full float32 (TF32
  is switched off where the detector is built: the JAX pyramid runs at
  ``Precision.HIGHEST``).  The golden capture and replay use it.
* ``blur_tiled`` — the detector's blur: the same operators cut into
  128-row bands (core/gaussian.banded_blocks_multi), applied by one row
  gather, one batched product, one column gather (and a copy into batch
  order) and one batched product, written straight into the padded
  pyramid layout.
* ``blur_conv`` — reflect-101 padding by a static index gather, then a
  vertical and a horizontal 1-D convolution (``blur_impl="conv"``).  The
  JAX body is an XLA convolution, not a Pallas kernel; here it is
  ``torch.nn.functional.conv2d`` (cuDNN on the card), run with cuDNN's
  TF32 off for the call whatever the process set.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from sift_tpu_torch.core.gaussian import reflect101_index


def blur_matmul(img: torch.Tensor, op_v: torch.Tensor,
                op_h: torch.Tensor) -> torch.Tensor:
    """``op_v @ img @ op_h.T``.

    img: [..., H, W]; op_v: [H, H] (or broadcast-batched [..., H, H]);
    op_h: [W, W] likewise.  float32 throughout.
    """
    out = torch.matmul(op_v, img)
    return torch.matmul(out, op_h.transpose(-1, -2))


class TiledOperator(NamedTuple):
    """One band-blocked operator pair (``SiftPlan.tiled_v[o]`` /
    ``tiled_h[o]``, ``init_tiled``, ``carry_tiled[o]``) on a device, in
    the form ``blur_tiled`` multiplies (built once by
    ``tiled_operator``)."""

    vblk: torch.Tensor   # [nT, NL*T, Bv]: row tile t's layers, stacked
    rows: torch.Tensor   # [nT*Bv] int64: the input row of each band row
    cols: torch.Tensor   # [nTc*Bh] int64: the input column of each band
    #                      column, column tile by column tile
    hblk: torch.Tensor   # [NL*nTc, Bh, Tc]: (layer, column tile), transposed


def tiled_operator(pair, device=None) -> TiledOperator:
    """``((vblocks, voffs), (hblocks, hoffs))`` of the plan, as numpy
    (vblocks [nT, NL, T, Bv], hblocks [nTc, NL, Tc, Bh]), moved to
    ``device`` in ``blur_tiled``'s form."""
    (vb, vo), (hb, ho) = pair
    nt, nl, t, bv = vb.shape
    ntc, _, tc, bh = hb.shape
    i64 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int64, device=device)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=device)
    return TiledOperator(
        vblk=f32(vb.reshape(nt, nl * t, bv)),
        rows=i64((np.asarray(vo)[:, None] + np.arange(bv)).reshape(-1)),
        cols=i64((np.asarray(ho)[:, None] + np.arange(bh)).reshape(-1)),
        hblk=f32(hb.transpose(1, 0, 3, 2).reshape(nl * ntc, bh, tc)))


def blur_tiled(base: torch.Tensor, op: TiledOperator) -> torch.Tensor:
    """All of one octave's layers from its base through a band-blocked
    operator pair, in the PADDED pyramid layout: returns
    ``[NL, nT*T, nTc*Tc]`` with the content where the operators put it
    (rows [HALO, HALO + h), columns [0, w) for a layer stack) and zeros
    elsewhere — the padding is zero rows of the operators, so it costs
    nothing.  ``base``: ``[h_in, w_in]``, or larger (a padded base of a
    previous call): rows and columns past the operators' input are never
    read.

    Counterpart of the JAX package's ``blur_tiled`` (one einsum over the
    row tiles, then one per column tile, in that order), as five device
    operations whatever the tile counts: gather every row tile's band of
    input rows (``index_select``), one batched product ``[nT] [NL*T, Bv]
    @ [Bv, w_in]``, gather every column tile's band of columns
    (``index_select``), one copy that brings (layer, column tile) to the
    front, one batched product ``[NL*nTc] [rows, Bh] @ [Bh, Tc]``.  The
    second product writes its blocks straight into the result, stored
    rows-major over layers (``[rows, NL, columns]`` in memory, returned as
    the ``[NL, rows, columns]`` view: layer stride = columns, row pitch =
    NL * columns), where block (layer l, column tile c) starts at
    (l * nTc + c) * Tc — one batch stride.  Each product contracts over
    the band only: O(n * band * w) against the dense operators'
    O(n^2 * w)."""
    nt, m, bv = op.vblk.shape
    nb, bh, tc = op.hblk.shape
    ntc = op.cols.shape[0] // bh
    nl = nb // ntc
    t = m // nl
    w_in = base.shape[1]
    tiles = base.index_select(0, op.rows).view(nt, bv, w_in)
    x = torch.bmm(op.vblk, tiles).view(nt * m, w_in)
    xc = x.index_select(1, op.cols).view(nt, nl, t, ntc, bh)
    xg = xc.permute(1, 3, 0, 2, 4).contiguous().view(nb, nt * t, bh)
    out = torch.empty((nt * t, nl, ntc * tc), dtype=x.dtype,
                      device=x.device)
    torch.bmm(xg, op.hblk, out=out.view(nt * t, nb, tc).transpose(0, 1))
    return out.transpose(0, 1)


@contextlib.contextmanager
def _cudnn_tf32_off():
    """cuDNN's TF32 off for the convolutions inside."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def reflect_pad_index(length: int, half: int, device=None) -> torch.Tensor:
    """The source index of each of the ``length + 2 * half`` rows of a
    reflect-101 padded axis (any pad size, also one larger than the axis,
    which ``F.pad(mode="reflect")`` refuses)."""
    idx = reflect101_index(np.arange(-half, length + half), length)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def blur_conv(img: torch.Tensor, kernel_1d: torch.Tensor,
              pad_index: Optional[Mapping] = None) -> torch.Tensor:
    """Separable reflect-101 blur by convolution, vertical pass first (the
    reference's order, FilterImpl.cuh:23).  img: [H, W] or [B, H, W].

    ``pad_index``: ``{(length, half): reflect_pad_index(length, half)}``
    already on the image's device (``ops/pyramid.plan_operators`` builds it
    for the conv pyramid); without it both indices are built here and
    copied to the device on every call."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[None]
    k = kernel_1d.shape[0]
    half = k // 2
    h, w_len = img.shape[1:]
    if pad_index is None:
        pad_index = {(n, half): reflect_pad_index(n, half, img.device)
                     for n in (h, w_len)}
    w = torch.as_tensor(kernel_1d, device=img.device).to(img.dtype)
    conv = torch.nn.functional.conv2d
    with _cudnn_tf32_off():
        x = img.index_select(1, pad_index[(h, half)])
        x = conv(x[:, None], w.reshape(1, 1, k, 1))[:, 0]
        x = x.index_select(2, pad_index[(w_len, half)])
        x = conv(x[:, None], w.reshape(1, 1, 1, k))[:, 0]
    return x[0] if squeeze else x

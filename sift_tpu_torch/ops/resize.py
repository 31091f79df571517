"""Bilinear resize.

Counterpart of ``sift_tpu/ops/resize.py``.  ``resize_matmul``: bilinear
resize is separable and linear, so it is two matmuls with precomputed
[out, in] operators (core/gaussian.resize_operator) and composes with the
blur operators.  ``resize_bilinear``: the same coordinate math as two
row/column gathers, for callers without operators.
"""

from __future__ import annotations

import torch


def resize_matmul(img: torch.Tensor, op_v: torch.Tensor,
                  op_h: torch.Tensor) -> torch.Tensor:
    """``op_v @ img @ op_h.T``; img [..., H_in, W_in] -> [..., H_out, W_out]."""
    out = torch.matmul(op_v, img)
    return torch.matmul(out, op_h.transpose(-1, -2))


def _axis_taps(n_out: int, n_in: int, device):
    """Per output index: the two source indices (edge-clamped) and the
    weight of the second, at centre-aligned ``(i + 0.5) * in/out - 0.5``."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    coord = (i + 0.5) * (n_in / n_out) - 0.5
    lo = torch.floor(coord)
    frac = coord - lo
    i1 = torch.clamp(lo.to(torch.int64), 0, n_in - 1)
    i2 = torch.clamp(torch.where(frac == 0, lo + 1, torch.ceil(coord))
                     .to(torch.int64), 0, n_in - 1)
    return i1, i2, frac


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Direct (gather-based) bilinear resize with the reference's
    coordinate math (``resize_cuda_bilinear``, Resize.cu:6-64), for callers
    without precomputed operators.  img [..., H, W] -> [..., out_h, out_w]
    (any leading batch shape)."""
    h, w = img.shape[-2], img.shape[-1]
    y1, y2, fy = _axis_taps(out_h, h, img.device)
    x1, x2, fx = _axis_taps(out_w, w, img.device)
    r1 = img.index_select(-2, y1)
    r2 = img.index_select(-2, y2)
    row = r1 * (1.0 - fy)[:, None] + r2 * fy[:, None]
    c1 = row.index_select(-1, x1)
    c2 = row.index_select(-1, x2)
    return c1 * (1.0 - fx) + c2 * fx

"""Bilinear resize as two matrix products.

Counterpart of ``sift_tpu/ops/resize.py`` (``resize_matmul``): bilinear
resize is separable and linear, so it is two matmuls with precomputed
[out, in] operators (core/gaussian.resize_operator) and composes with the
blur operators.
"""

from __future__ import annotations

import torch


def resize_matmul(img: torch.Tensor, op_v: torch.Tensor,
                  op_h: torch.Tensor) -> torch.Tensor:
    """``op_v @ img @ op_h.T``; img [..., H_in, W_in] -> [..., H_out, W_out]."""
    out = torch.matmul(op_v, img)
    return torch.matmul(out, op_h.transpose(-1, -2))

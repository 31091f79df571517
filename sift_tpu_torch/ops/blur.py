"""Separable Gaussian blur as two dense matrix products.

Counterpart of ``sift_tpu/ops/blur.py`` (``blur_matmul``): the blur with
precomputed banded operators (core/gaussian.blur_operator), boundary
handling baked into the operator, layers batched by broadcasting.  These
are large plain matrix products and go to ``torch.matmul`` in full float32
(TF32 is switched off where the detector is built: the JAX pyramid runs at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch


def blur_matmul(img: torch.Tensor, op_v: torch.Tensor,
                op_h: torch.Tensor) -> torch.Tensor:
    """``op_v @ img @ op_h.T``.

    img: [..., H, W]; op_v: [H, H] (or broadcast-batched [..., H, H]);
    op_h: [W, W] likewise.  float32 throughout.
    """
    out = torch.matmul(op_v, img)
    return torch.matmul(out, op_h.transpose(-1, -2))

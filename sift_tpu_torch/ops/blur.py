"""Separable Gaussian blur.

Counterpart of ``sift_tpu/ops/blur.py``, two implementations:

* ``blur_matmul`` — the blur as two dense matrix products with precomputed
  banded operators (core/gaussian.blur_operator), boundary handling baked
  into the operator, layers batched by broadcasting.  These are large
  plain matrix products and go to ``torch.matmul`` in full float32 (TF32
  is switched off where the detector is built: the JAX pyramid runs at
  ``Precision.HIGHEST``).
* ``blur_conv`` — reflect-101 padding by a static index gather, then a
  vertical and a horizontal 1-D convolution (``blur_impl="conv"``).  The
  JAX body is an XLA convolution, not a Pallas kernel; here it is
  ``torch.nn.functional.conv2d`` (cuDNN on the card), run with cuDNN's
  TF32 off for the call whatever the process set.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional

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

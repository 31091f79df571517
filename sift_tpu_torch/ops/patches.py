"""Batched square-patch gathering around keypoints.

Counterpart of ``sift_tpu/ops/patches.py``: a static-size patch per
keypoint by one flat gather with clamped indices (consumers mask pixels
whose unclamped coordinates fall outside the image), and central
differences on the gathered patches.  Nothing on the detector's path calls
these; they are part of the package's API, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gather_patches(block: torch.Tensor, layer: torch.Tensor,
                   cy: torch.Tensor, cx: torch.Tensor, size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """block: [D, H, W]; layer/cy/cx: [K] integer patch centres.

    Returns (patch [K, size, size], dy_off [size], dx_off [size]) where
    patch[k, i, j] = block[layer[k], cy[k] + i - R, cx[k] + j - R] with
    clamped indices (R = size // 2); the offsets are int32."""
    d, h, w = block.shape
    r = size // 2
    dev = block.device
    off = torch.arange(size, dtype=torch.int32, device=dev) - r
    cy, cx = cy.to(torch.int64), cx.to(torch.int64)
    ys = torch.clamp(cy[:, None] + off[None, :], 0, h - 1)       # [K, S]
    xs = torch.clamp(cx[:, None] + off[None, :], 0, w - 1)       # [K, S]
    lidx = torch.clamp(layer.to(torch.int64), 0, d - 1)[:, None, None] \
        * (h * w)
    idx = lidx + ys[:, :, None] * w + xs[:, None, :]             # [K, S, S]
    patch = block.reshape(-1)[idx.reshape(-1)].reshape(-1, size, size)
    return patch, off, off


def patch_gradients(patch: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences on gathered patches [K, S, S]:
    dx[i, j] = p[i, j+1] - p[i, j-1]; dy[i, j] = p[i-1, j] - p[i+1, j]
    (the reference's gradient convention, SiftOps.cu:315-317,553-556),
    over the inner [K, S-2, S-2] region (the rim has no gradient)."""
    dx = patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]
    dy = patch[:, :-2, 1:-1] - patch[:, 2:, 1:-1]
    return dx, dy

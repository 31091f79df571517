"""3-D DoG extrema detection.

Counterpart of ``sift_tpu/ops/peaks.py`` (``peak_mask``,
``find_candidates``): a pixel is a
candidate when |v| > threshold and v is a (>=/<=) extremum over its 26
neighbours across three adjacent DoG layers, within an image border margin
(the capability of the reference's ``findPeaks3D``, MatOps.cu:40-182).
This is part of the arithmetic of the plain version of the record-field
kernel (kernels/fused_detect.py).

Neighbours outside the image are read from the nearest edge pixel — the
CUDA kernel clamps its reads the same way.  A replicated edge value is
already inside the 27-window, so the pooled max/min equal those of the JAX
package's -inf/+inf padding at every pixel.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.ops.compact import stream_compact


def clamp_pad(a: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H+2, W+2] with a 1-px edge-replicated rim
    (works for any H, W >= 1, unlike ``F.pad(mode='replicate')`` ranks)."""
    h, w = a.shape[-2:]
    iy = torch.arange(-1, h + 1, device=a.device).clamp_(0, h - 1)
    ix = torch.arange(-1, w + 1, device=a.device).clamp_(0, w - 1)
    return a.index_select(-2, iy).index_select(-1, ix)


def _pool3(dogp: torch.Tensor, op) -> torch.Tensor:
    """27-window pooling of an edge-padded DoG stack [D, H+2, W+2] ->
    [D-2, H, W] (layers 1..D-2): separable passes over layer, row, col."""
    d, hp, wp = dogp.shape
    h, w = hp - 2, wp - 2
    z = op(op(dogp[0:d - 2], dogp[1:d - 1]), dogp[2:d])
    y = op(op(z[:, 0:h], z[:, 1:h + 1]), z[:, 2:h + 2])
    return op(op(y[:, :, 0:w], y[:, :, 1:w + 1]), y[:, :, 2:w + 2])


def peak_mask(dog: torch.Tensor, threshold: float, border: int,
              dogp: torch.Tensor = None):
    """dog: [D, H, W].  Returns (mask, score) of shape [D-2, H, W] aligned to
    DoG layers 1..D-2 (the candidate layer index is l+1).  ``dogp``: the
    edge-padded stack if the caller already has it."""
    d, h, w = dog.shape
    c = dog[1:-1]
    if dogp is None:
        dogp = clamp_pad(dog)
    mx = _pool3(dogp, torch.maximum)
    mn = _pool3(dogp, torch.minimum)

    is_max = (c > 0) & (c >= mx)
    is_min = (c < 0) & (c <= mn)
    mask = (c.abs() > threshold) & (is_max | is_min)

    # Border mask (MatOps.cu:105-114): x,y in [border, size - border).
    ys = torch.arange(h, device=dog.device)[:, None]
    xs = torch.arange(w, device=dog.device)[None, :]
    inb = ((ys >= border) & (ys < h - border)
           & (xs >= border) & (xs < w - border))
    return mask & inb[None], c.abs()


def find_candidates(dog: torch.Tensor, threshold: float, border: int,
                    cap: int):
    """Returns candidate (x, y, layer, valid) tensors of length ``cap``:
    the first ``cap`` extrema in (layer, y, x) order.  ``layer`` is the
    DoG layer index (1..D-2), matching the reference's candidateKpts z
    (MatOps.cu:177)."""
    h, w = dog.shape[1], dog.shape[2]
    mask, _ = peak_mask(dog, threshold, border)
    idx, valid = stream_compact(mask.reshape(-1), cap)
    lyr = idx // (h * w) + 1
    rem = idx % (h * w)
    return ((rem % w).to(torch.int32), (rem // w).to(torch.int32),
            lyr.to(torch.int32), valid)

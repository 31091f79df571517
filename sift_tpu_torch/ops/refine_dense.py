"""Dense Newton records: the 3-D quadratic solve for every DoG pixel.

Counterpart of ``sift_tpu/ops/refine_dense.py`` (``record_fields``,
``RefinedKeypoints``): the capability of the reference's ``adjustExtrema``
per-step solve (SiftOps.cu:63-208) — 1/255-scaled derivatives, a
vectorised Cramer solve of the 3x3 system, convergence / divergence flags,
contrast, and the Hessian edge test — for the whole volume at once.  This
is the arithmetic of the plain version of the record-field kernel
(kernels/fused_detect.py), written expression for expression like the
kernel so the two decide alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_tpu_torch.ops.peaks import clamp_pad

_IMG_SCALE = 1.0 / 255.0
_DERIV_SCALE = _IMG_SCALE * 0.5
_SECOND_DERIV_SCALE = _IMG_SCALE
_CROSS_DERIV_SCALE = _IMG_SCALE * 0.25


class RefinedKeypoints(NamedTuple):
    x: torch.Tensor         # base-image-space x (float)
    y: torch.Tensor
    layer: torch.Tensor     # final integer layer (1..L)
    xi: torch.Tensor        # sub-pixel layer offset (OpenCV's xi)
    size: torch.Tensor      # base-image-space diameter
    response: torch.Tensor  # |contrast|
    valid: torch.Tensor


def record_fields(dog: torch.Tensor, edge_threshold: float,
                  dogp: torch.Tensor = None):
    """dog [D, H, W] -> five [D-2, H, W] record channels
    (x0, x1, x2, |contrast|, flags) for layers 1..D-2, flags =
    conv | div<<1 | edge_ok<<2.  Neighbours outside the image are the
    nearest edge pixel (rim records are garbage by contract either way:
    the walk never consults them for live candidates)."""
    d, h, w = dog.shape
    if dogp is None:
        dogp = clamp_pad(dog)

    def sh(dl, dr, dc):
        return dogp[1 + dl:d - 1 + dl, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    v = dog[1:d - 1]
    dx = (sh(0, 0, 1) - sh(0, 0, -1)) * _DERIV_SCALE
    dy = (sh(0, 1, 0) - sh(0, -1, 0)) * _DERIV_SCALE
    ds = (sh(1, 0, 0) - sh(-1, 0, 0)) * _DERIV_SCALE
    v2 = v * 2.0
    dxx = (sh(0, 0, 1) + sh(0, 0, -1) - v2) * _SECOND_DERIV_SCALE
    dyy = (sh(0, 1, 0) + sh(0, -1, 0) - v2) * _SECOND_DERIV_SCALE
    dss = (sh(1, 0, 0) + sh(-1, 0, 0) - v2) * _SECOND_DERIV_SCALE
    dxy = (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1)) \
        * _CROSS_DERIV_SCALE
    dxs = (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1)) \
        * _CROSS_DERIV_SCALE
    dys = (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0)) \
        * _CROSS_DERIV_SCALE

    # Cramer solve of A x = dD (A = Hessian), vectorised per pixel.
    det = (dxx * (dyy * dss - dys * dys)
           - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    ok = det.abs() > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    x0 = (dx * (dyy * dss - dys * dys)
          - dxy * (dy * dss - dys * ds)
          + dxs * (dy * dys - dyy * ds)) / safe
    x1 = (dxx * (dy * dss - dys * ds)
          - dx * (dxy * dss - dys * dxs)
          + dxs * (dxy * ds - dy * dxs)) / safe
    x2 = (dxx * (dyy * ds - dy * dys)
          - dxy * (dxy * ds - dy * dxs)
          + dx * (dxy * dys - dyy * dxs)) / safe

    conv = (x0.abs() < 0.5) & (x1.abs() < 0.5) & (x2.abs() < 0.5) & ok
    div = (x0.abs() > w) | (x1.abs() > h) | (x2.abs() > 100.0) | ~ok

    contrast = v * _IMG_SCALE - (dx * x0 + dy * x1 + ds * x2) * 0.5
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    et = float(edge_threshold)
    edge_ok = (det2 > 0) & (tr * tr * et < (et + 1.0) * (et + 1.0) * det2)

    flags = (conv.to(torch.float32) + 2.0 * div.to(torch.float32)
             + 4.0 * edge_ok.to(torch.float32))
    return x0, x1, x2, contrast.abs(), flags

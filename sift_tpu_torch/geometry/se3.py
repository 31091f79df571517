"""SO(3)/SE(3) utilities for the SfM layer.

Counterpart of ``sift_tpu/geometry/se3.py``: minimal, fully batchable
rotation/pose math used by two-view geometry, pose-graph optimization and
bundle adjustment, as plain functions on tensors with a leading batch
shape.  They run under ``torch.func.jacfwd`` / ``vmap``.

The small-angle branches select with ``torch.where`` and never by a
multiplied mask: at a zero twist the derivative of ``theta`` is 0/0 in the
branch that is not selected, and ``where`` drops that tangent (as
``jnp.where`` does) where a product would turn it into NaN.

Conventions: rotations are 3x3 matrices; poses (R, t) map world points to
camera frame: x_cam = R @ x_world + t.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    k = hat(w)
    k2 = k @ k
    t = torch.clamp(theta, min=_EPS)
    a = torch.sin(t) / t
    b = (1.0 - torch.cos(t)) / (t * t)
    eye = _eye_like(k)
    small = theta[..., 0, 0] < 1e-7
    r = eye + a * k + b * k2
    r_small = eye + k + 0.5 * k2
    return torch.where(small[..., None, None], r_small, r)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                     r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], -1)
    s = torch.clamp(2.0 * torch.sin(theta), min=_EPS)
    w = v * (theta / s)[..., None]
    # theta -> 0: log(R) ~ v / 2
    return torch.where((theta < 1e-7)[..., None], v * 0.5, w)


def se3_exp(xi: torch.Tensor):
    """[..., 6] twist (v, w) -> (R [...,3,3], t [...,3])."""
    v, w = xi[..., :3], xi[..., 3:]
    r = so3_exp(w)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    k = hat(w)
    k2 = k @ k
    t_ = torch.clamp(theta, min=_EPS)
    b = (1.0 - torch.cos(t_)) / (t_ * t_)
    c = (t_ - torch.sin(t_)) / (t_ * t_ * t_)
    eye = _eye_like(k)
    jac = eye + b * k + c * k2
    jac_small = eye + 0.5 * k
    small = theta[..., 0, 0] < 1e-7
    jac = torch.where(small[..., None, None], jac_small, jac)
    t = (jac @ v[..., None])[..., 0]
    return r, t


def compose(ra, ta, rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return ra @ rb, (ra @ tb[..., None])[..., 0] + ta


def inverse(r, t):
    rt = r.transpose(-1, -2)
    return rt, -(rt @ t[..., None])[..., 0]


def transform(r, t, pts):
    """Apply pose to [..., N, 3] points."""
    return pts @ r.transpose(-1, -2) + t[..., None, :]


def project(pts_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Pinhole projection of camera-frame points [..., N, 3] -> [..., N, 2]."""
    z = torch.clamp(pts_cam[..., 2:3], min=1e-9)
    uv = pts_cam[..., :2] / z
    return torch.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], -1)

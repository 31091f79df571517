"""Perspective-n-Point: robust Gauss-Newton pose from 3D-2D
correspondences.

Counterpart of ``sift_tpu/geometry/pnp.py``.  For video odometry the
previous frame's pose is an excellent initialization, so a damped GN on the
6-DOF left-increment twist with a truncated reprojection loss is simpler
and more robust than minimal-solver RANSAC, and it is one fixed-iteration
program with no host synchronisation.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.geometry import se3


def _reprojection(xi, r, t, points_w, uv, fx, fy, cx, cy):
    """Residuals [N, 2] and behind-camera mask [N] of (r, t) moved by the
    left-increment twist ``xi`` [6]."""
    dr, dt = se3.se3_exp(xi)
    rr = dr @ r
    tt = (dr @ t[..., None])[..., 0] + dt
    pc = points_w @ rr.T + tt
    z = torch.clamp(pc[:, 2], min=1e-6)
    proj = torch.stack([pc[:, 0] / z * fx + cx,
                        pc[:, 1] / z * fy + cy], -1)
    behind = pc[:, 2] <= 1e-6
    return proj - uv, behind


def pnp_gn(points_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
           fx, fy, cx, cy, r0: torch.Tensor, t0: torch.Tensor,
           iters: int = 12, threshold_px: float = 3.0,
           damping: float = 1e-6):
    """points_w: [N, 3] world points; uv: [N, 2] pixels; (r0, t0) initial
    world->camera pose.  Returns (r, t, inliers, mean_err_px).

    Robust truncated loss with ANNEALED threshold: iteration i gates at
    ``threshold_px * max(2^(iters/2 - i), 1)`` so far-off initializations
    converge first coarsely, then tightly; the final inlier set uses the
    tight gate."""
    dt = points_w.dtype
    dev = points_w.device
    anneal = [max(2.0 ** (iters / 2 - i), 1.0) for i in range(iters)]
    zero = torch.zeros((6,), dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    intr = (fx, fy, cx, cy)
    r, t = r0.to(dt), t0.to(dt)
    for mult in anneal:
        thr2 = (threshold_px * mult) ** 2
        res, behind = _reprojection(zero, r, t, points_w, uv, *intr)
        err2 = torch.sum(res * res, -1)
        w = (valid & ~behind & (err2 < thr2)).to(dt)
        jac = torch.func.jacfwd(
            lambda xi, r=r, t=t: _reprojection(xi, r, t, points_w, uv,
                                               *intr)[0])(zero).to(dt)
        jw = jac * w[:, None, None]                        # [N, 2, 6]
        h = torch.einsum("nki,nkj->ij", jw, jac) + damping * eye6
        g = torch.einsum("nki,nk->i", jw, res)
        d = -torch.linalg.solve_ex(h, g).result   # no error-check sync
        dr, dtr = se3.se3_exp(d)
        r, t = dr @ r, (dr @ t[..., None])[..., 0] + dtr
    res, behind = _reprojection(zero, r, t, points_w, uv, *intr)
    err2 = torch.sum(res * res, -1)
    inliers = valid & ~behind & (err2 < threshold_px * threshold_px)
    n = torch.clamp(torch.sum(inliers), min=1)
    mean_err = torch.sqrt(torch.sum(torch.where(inliers, err2,
                                                torch.zeros_like(err2))) / n)
    return r, t, inliers, mean_err

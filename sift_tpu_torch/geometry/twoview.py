"""Two-view geometry: batched 8-point essential estimation, vectorized
RANSAC, pose recovery and triangulation.

Counterpart of ``sift_tpu/geometry/twoview.py``.  RANSAC is not a
sequential hypothesize-and-verify loop: ALL hypotheses are solved in one
batch of small SVDs and scored against all correspondences in one [H, N]
computation; the top seeds are polished in one batch over a leading seed
axis.  No data-dependent control flow and no host synchronisation.

Where the port differs from the JAX module, and why:
  * Random draws: ``ransac_essential`` draws its [H, S] sample indices with
    ``torch.multinomial`` over the valid mask from an explicit
    ``torch.Generator`` (JAX: ``jax.random.categorical`` over split keys),
    then calls ``ransac_from_samples``, which takes the indices — so both
    packages can be fed the same samples.
  * Ties: ``jax.lax.top_k`` returns equal scores lowest index first; the
    port takes a stable descending sort.  Both argmaxes return the first
    maximum.
  * SVD signs: a singular vector may come out negated against LAPACK's, so
    an essential matrix may be ``-E``; Sampson error and ``recover_pose``'s
    determinant-sign fix absorb it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_tpu_torch.geometry import se3


class TwoViewResult(NamedTuple):
    e_matrix: torch.Tensor     # [3, 3] essential matrix
    rotation: torch.Tensor     # [3, 3]
    translation: torch.Tensor  # [3] unit norm
    inliers: torch.Tensor      # [N] bool
    points3d: torch.Tensor     # [N, 3] triangulated (in camera-1 frame)
    num_inliers: torch.Tensor  # scalar int32


def pixels_to_normalized(pts: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """[N, 2] pixels -> normalized camera coordinates."""
    return torch.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], -1)


def _epipolar_system(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] point pairs -> [..., N, 9] rows of the epipolar
    constraint x2^T E x1 = 0 (x = (u, v, 1))."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                        u1, v1, one], -1)


def eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Least-squares epipolar matrix from [..., N>=8, 2] normalized
    correspondences; returns [..., 3, 3] with essential-matrix singular
    values enforced (1, 1, 0)."""
    a = _epipolar_system(p1, p2)
    # Null vector: right-singular vector of the smallest singular value
    # (full_matrices: an exactly-8-point system is [8, 9]).
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    u, _, vt2 = torch.linalg.svd(e)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=e.dtype, device=e.device)
    return (u * s[..., None, :]) @ vt2


def _homogeneous_products(e, p1, p2):
    one = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, one], -1)
    x2 = torch.cat([p2, one], -1)
    ex1 = x1 @ e.transpose(-1, -2)               # E @ x1, batched
    etx2 = x2 @ e                                # E^T @ x2
    num = torch.sum(x2 * ex1, -1)
    den = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2
           + etx2[..., 0] ** 2 + etx2[..., 1] ** 2)
    return num, den


def sampson_error(e: torch.Tensor, p1: torch.Tensor,
                  p2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error, [..., N]."""
    num, den = _homogeneous_products(e, p1, p2)
    return num ** 2 / torch.clamp(den, min=1e-12)


def _signed_sampson(e, p1, p2):
    num, den = _homogeneous_products(e, p1, p2)
    return num / torch.sqrt(torch.clamp(den, min=1e-12))


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _tangent_basis(t):
    """Two unit vectors orthogonal to t (and each other); t [..., 3]."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    helper = torch.where((torch.abs(t[..., 0]) < 0.9)[..., None], ex, ey)
    b1 = _unit(torch.linalg.cross(t, helper))
    b2 = torch.linalg.cross(t, b1)
    return b1, b2


def _sampson_residuals(params, r, t, b1, b2, p1, p2):
    """Signed Sampson residuals [N] of one seed (r, t) moved by a 5-DOF
    increment ``params`` [5]."""
    rr = se3.so3_exp(params[:3]) @ r
    tt = _unit(t + b1 * params[3:4] + b2 * params[4:5])
    return _signed_sampson(se3.hat(tt) @ rr, p1, p2)


def refine_essential_gn(r0, t0, p1, p2, valid, threshold,
                        iters: int = 10, damping: float = 1e-8):
    """Gauss-Newton polish ON the essential manifold: 5 DOF (left-rotation
    increment + translation-sphere tangent), robust truncated Sampson loss.
    Every iterate is an essential matrix, so the polish cannot leave the
    manifold.  Fixed iteration count, no host synchronisation.

    Batched over any leading seed shape: r0 [..., 3, 3], t0 [..., 3];
    p1/p2 [N, 2] and valid [N] are shared (``torch.func.vmap`` over the
    seeds, as the JAX module's ``jax.vmap(polish)``)."""
    lead = t0.shape[:-1]
    dt = p1.dtype
    r = r0.reshape(-1, 3, 3)
    t = t0.reshape(-1, 3)
    eye5 = torch.eye(5, dtype=dt, device=p1.device)
    zero = torch.zeros((t.shape[0], 5), dtype=dt, device=p1.device)
    res = torch.func.vmap(_sampson_residuals,
                          in_dims=(0, 0, 0, 0, 0, None, None))
    jac_fn = torch.func.vmap(torch.func.jacfwd(_sampson_residuals),
                             in_dims=(0, 0, 0, 0, 0, None, None))
    for _ in range(iters):
        b1, b2 = _tangent_basis(t)
        r_vec = res(zero, r, t, b1, b2, p1, p2)               # [B, N]
        jac = jac_fn(zero, r, t, b1, b2, p1, p2).to(dt)       # [B, N, 5]
        w = ((r_vec * r_vec < threshold) & valid).to(dt)
        jw = jac * w[..., None]
        h = jw.transpose(-1, -2) @ jac + damping * eye5
        g = (jw.transpose(-1, -2) @ r_vec[..., None])[..., 0]
        d = -torch.linalg.solve_ex(h, g).result   # no error-check sync
        r = se3.so3_exp(d[:, :3]) @ r
        t = _unit(t + b1 * d[:, 3:4] + b2 * d[:, 4:5])
    return r.reshape(*lead, 3, 3), t.reshape(*lead, 3)


def ransac_from_samples(p1: torch.Tensor, p2: torch.Tensor,
                        valid: torch.Tensor, idx: torch.Tensor,
                        threshold: float = 1e-5,
                        refit_iters: int = 10) -> TwoViewResult:
    """RANSAC on GIVEN sample indices ``idx`` [H, S] into the [N]
    correspondences: the hypotheses' least-squares fits, their consensus,
    the top-24 seeds polished in one batch, the largest polished consensus
    kept.  Everything after the draws of the JAX ``ransac_essential``."""
    n_hypotheses = idx.shape[0]
    idx = idx.to(torch.int64)
    h1 = p1[idx]                                          # [H, S, 2]
    h2 = p2[idx]
    es = eight_point(h1, h2)                              # [H, 3, 3]

    err = sampson_error(es, p1[None], p2[None])           # [H, N]
    inl = (err < threshold) & valid[None]
    scores = torch.sum(inl, -1)

    # Local optimization from the TOP-M seeds in one batch, selecting by
    # post-polish consensus.  Stable descending sort: equal scores keep
    # the lower index first, as jax.lax.top_k does.
    m_seeds = min(24, n_hypotheses)
    seed_idx = torch.sort(scores, descending=True, stable=True).indices[
        :m_seeds]

    r0, t0, _ = recover_pose(es[seed_idx], p1, p2, inl[seed_idx])
    r, t = refine_essential_gn(r0, t0, p1, p2, valid, threshold,
                               iters=refit_iters)
    es_m = se3.hat(t) @ r                                 # [M, 3, 3]
    err2 = sampson_error(es_m, p1[None], p2[None])        # [M, N]
    inl_m = (err2 < threshold) & valid[None]
    counts_m = torch.sum(inl_m, -1)
    b = torch.argmax(counts_m)       # first maximum, as jnp.argmax
    e = es_m[b]
    inliers = inl_m[b]

    r, t, pts3d = recover_pose(e, p1, p2, inliers)
    return TwoViewResult(e_matrix=e, rotation=r, translation=t,
                         inliers=inliers, points3d=pts3d,
                         num_inliers=torch.sum(inliers).to(torch.int32))


def draw_samples(valid: torch.Tensor, n_hypotheses: int, sample_size: int,
                 generator: torch.Generator) -> torch.Tensor:
    """[H, S] int64 sample indices, drawn with replacement from the valid
    rows (uniformly), from ``generator`` on ``valid``'s device."""
    w = valid.to(torch.float32)
    w = torch.where(valid.any(), w, torch.ones_like(w))   # none valid: all
    return torch.multinomial(w.expand(n_hypotheses, -1), sample_size,
                             replacement=True, generator=generator)


def ransac_essential(p1: torch.Tensor, p2: torch.Tensor,
                     valid: torch.Tensor, generator: torch.Generator,
                     n_hypotheses: int = 512,
                     threshold: float = 1e-5,
                     sample_size: int = 16,
                     refit_iters: int = 10) -> TwoViewResult:
    """Vectorized RANSAC over normalized correspondences.

    p1/p2: [N, 2]; valid: [N] bool; threshold on SQUARED Sampson error in
    normalized coords ((px_err / f)^2 scale).  ``generator``: the
    ``torch.Generator`` (on p1's device) the samples are drawn from.
    Non-minimal ``sample_size``-point fits, as in the JAX module: minimal
    8-point fits are too ill-conditioned at small baselines."""
    idx = draw_samples(valid, n_hypotheses, sample_size, generator)
    return ransac_from_samples(p1, p2, valid, idx, threshold, refit_iters)


def triangulate(r: torch.Tensor, t: torch.Tensor, p1: torch.Tensor,
                p2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation in camera-1 frame.  Camera 1 is
    [I | 0], camera 2 is [R | t]; p1/p2 normalized coords [..., N, 2].
    Closed-form 4x4 homogeneous solve via SVD, batched; (r, t) may carry
    leading batch axes that broadcast against the points'."""
    lead = torch.broadcast_shapes(p1.shape[:-1], p2.shape[:-1],
                                  (*r.shape[:-2], p1.shape[-2]))
    p1, p2 = p1.expand(*lead, 2), p2.expand(*lead, 2)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand(
        *lead, 3, 3)

    def rows(proj_r, proj_t, p):
        p3 = torch.cat([proj_r[..., 2, :], proj_t[..., 2:3]], -1)
        p1_ = torch.cat([proj_r[..., 0, :], proj_t[..., 0:1]], -1)
        p2_ = torch.cat([proj_r[..., 1, :], proj_t[..., 1:2]], -1)
        return (p[..., 0:1] * p3 - p1_, p[..., 1:2] * p3 - p2_)

    z = torch.zeros((*lead, 3), dtype=p1.dtype, device=p1.device)
    r1a, r1b = rows(eye, z, p1)
    rb = r[..., None, :, :].expand(*lead, 3, 3)
    tb = t[..., None, :].expand(*lead, 3)
    r2a, r2b = rows(rb, tb, p2)
    a = torch.stack([r1a, r1b, r2a, r2b], -2)             # [..., 4, 4]
    _, _, vt = torch.linalg.svd(a)
    x = vt[..., -1, :]
    w = x[..., 3:]
    return x[..., :3] / torch.where(torch.abs(w) < 1e-12,
                                    torch.full_like(w, 1e-12), w)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors: a few elementwise kernels
    where ``torch.linalg.det`` takes an LU factorization and, on its first
    CUDA call, a runtime-compiled product kernel (~0.9 s on an H100)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def recover_pose(e: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 inliers: torch.Tensor):
    """Decompose E into the 4 candidate (R, t) and pick the one with the
    most points in front of both cameras (cheirality) (≙ cv2.recoverPose).
    Batched over any leading shape of ``e`` [..., 3, 3] with ``inliers``
    [..., N]; p1/p2 [N, 2] are shared."""
    u, _, vt = torch.linalg.svd(e)
    # det(U), det(V) sign fix to keep rotations proper.
    u = u * torch.sign(_det3(u))[..., None, None]
    vt = vt * torch.sign(_det3(vt))[..., None, None]
    wmat = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device)
    r1 = u @ wmat @ vt
    r2 = u @ wmat.T @ vt
    tt = u[..., :, 2]
    rs = torch.stack([r1, r1, r2, r2], -3)                # [..., 4, 3, 3]
    ts = torch.stack([tt, -tt, tt, -tt], -2)              # [..., 4, 3]
    x1 = triangulate(rs, ts, p1, p2)                      # [..., 4, N, 3]
    x2 = se3.transform(rs, ts, x1)
    ok = (x1[..., 2] > 0) & (x2[..., 2] > 0) & inliers[..., None, :]
    scores = torch.sum(ok, -1)                            # [..., 4]
    b = torch.argmax(scores, -1)                          # first maximum
    lead, n = b.shape, p1.shape[-2]
    g = lambda a, *tail: torch.gather(
        a, len(lead), b.reshape(*lead, 1, *[1] * len(tail)).expand(
            *lead, 1, *tail)).squeeze(len(lead))
    return g(rs, 3, 3), g(ts, 3), g(x1, n, 3)

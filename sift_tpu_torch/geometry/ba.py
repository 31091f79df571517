"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction,
fully batched.

Counterpart of ``sift_tpu/geometry/ba.py``.  Design:

* Fixed-capacity observation table (camera_idx, point_idx, uv, valid mask).
* Analytic Jacobians per observation, batched [O, 2, 6] / [O, 2, 3].
* Normal equations assembled by segment sums into dense per-camera 6x6
  and per-point 3x3 blocks.
* Schur complement: eliminate points (3x3 block inverses, batched), solve
  the reduced camera system [6C, 6C] densely — C is small (keyframes).

Segment sums are DETERMINISTIC on every device (``Segments``): each
observation is placed at (segment, rank within the segment) of a dense
[n, width, ...] buffer — one write per slot, no atomics — and the buffer
is summed over its width.  A float ``index_add_`` on CUDA accumulates with
atomics in no fixed order, so it is not bit-reproducible, and the odometry
checkpoint promises a resume bit-identical to an uninterrupted run with
window BA inside that loop.  The plan needs the widest segment on the host:
one synchronisation when a problem is set up (``lm_optimize`` builds its
plans once, before the iterations), none per iteration: the small solves
and inverses are ``solve_ex`` / ``inv_ex``, which skip the error check
(and its synchronisation) as the JAX solves do.  The observation sums
also run over a table split into shards (``Shards``, for
``parallel/dba.py``): each shard's partial, summed in shard order.  One
LM loop (``lm_iterations``) serves both: ``lm_optimize`` is its one-shard
case.

Parameterization: camera i has twist xi in se(3) applied on the left of
(R_i, t_i); world points X_j; intrinsics fixed per problem.  Camera 0 is
fixed by masking its update; the scale gauge is left free (only LM's
damping holds it), as in the JAX module, so float32 runs of the two
packages may settle at slightly different scales.  Every array takes the
problem's dtype: float64 problems run in float64 on the CPU and on CUDA.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from sift_tpu_torch.geometry import se3


class BAProblem(NamedTuple):
    """Static-capacity bundle-adjustment problem."""

    rotations: torch.Tensor     # [C, 3, 3] world->camera
    translations: torch.Tensor  # [C, 3]
    points: torch.Tensor        # [P, 3] world points
    cam_idx: torch.Tensor       # [O] int
    pt_idx: torch.Tensor        # [O] int
    uv: torch.Tensor            # [O, 2] observed pixels
    valid: torch.Tensor         # [O] bool
    fx: object                  # scalar intrinsics (float or 0-dim tensor)
    fy: object
    cx: object
    cy: object


class BAState(NamedTuple):
    rotations: torch.Tensor
    translations: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor          # mean squared reprojection error (valid obs)
    lm_lambda: torch.Tensor


class Segments(NamedTuple):
    """Deterministic segment-sum plan for one fixed index array."""

    seg: torch.Tensor   # [O] int64 segment of each row
    rank: torch.Tensor  # [O] int64 position of the row inside its segment
    n: int              # number of segments
    width: int          # rows of the largest segment (>= 1)

    @staticmethod
    def build(idx: torch.Tensor, n: int) -> "Segments":
        """Rows keep their index order inside each segment (stable sort).
        Reads the widest segment to the host once."""
        seg = idx.to(torch.int64)
        o = seg.shape[0]
        counts = torch.bincount(seg, minlength=n)
        width = max(int(counts.max()), 1) if o else 1
        order = torch.sort(seg, stable=True).indices
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(o, device=seg.device) - start[seg[order]]
        rank = torch.empty_like(seg)
        rank[order] = pos
        return Segments(seg=seg, rank=rank, n=n, width=width)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """[O, ...] -> [n, ...]: the sum of each segment's rows, in row
        order — the same bits on every run."""
        buf = torch.zeros((self.n, self.width, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        buf[self.seg, self.rank] = x
        return buf.sum(1)


class Plan(NamedTuple):
    """The segment plans one problem's table needs."""

    cam: Segments    # by camera
    pt: Segments     # by point
    pair: Segments   # by (point, camera): point * C + camera


def plan_for(p: BAProblem) -> Plan:
    nc = p.rotations.shape[0]
    npts = p.points.shape[0]
    cam = p.cam_idx.to(torch.int64)
    pt = p.pt_idx.to(torch.int64)
    return Plan(cam=Segments.build(cam, nc), pt=Segments.build(pt, npts),
                pair=Segments.build(pt * nc + cam, npts * nc))


def _residuals_and_jacobians(p: BAProblem):
    """Residuals [O, 2] and Jacobians d_res/d_twist [O, 2, 6],
    d_res/d_point [O, 2, 3], zeroed on invalid observations.  Twist is a
    left-multiplied increment: (R', t') = exp(xi) * (R, t)."""
    cam = p.cam_idx.to(torch.int64)
    r = p.rotations[cam]
    x = p.points[p.pt_idx.to(torch.int64)]
    pc = (r @ x[..., None])[..., 0] + p.translations[cam]
    z = torch.clamp(pc[:, 2], min=1e-6)
    inv_z = 1.0 / z
    u = pc[:, 0] * inv_z * p.fx + p.cx
    v = pc[:, 1] * inv_z * p.fy + p.cy
    res = torch.stack([u, v], -1) - p.uv

    zero = torch.zeros_like(z)
    j_proj = torch.stack([
        torch.stack([p.fx * inv_z, zero, -p.fx * pc[:, 0] * inv_z * inv_z],
                    -1),
        torch.stack([zero, p.fy * inv_z, -p.fy * pc[:, 1] * inv_z * inv_z],
                    -1),
    ], -2)                                                    # [O, 2, 3]
    # Left-increment: d(pc)/d(v) = I, d(pc)/d(w) = -hat(pc)
    j_cam = torch.cat([j_proj, j_proj @ (-se3.hat(pc))], -1)  # [O, 2, 6]
    j_pt = j_proj @ r                                         # [O, 2, 3]
    w = p.valid.to(res.dtype)[:, None]
    return res * w, j_cam * w[..., None], j_pt * w[..., None]


def normal_equation_terms(p: BAProblem, plan: Optional[Plan] = None):
    """Observation-reduction half of the LM step: everything that is a
    sum over observations.  Shapes depend only on (C, P), never on the
    observation count.

    Returns (jtj_c [C,6,6], g_c [C,6], jtj_p [P,3,3], g_p [P,3],
    a_j [P,C,6,3])."""
    plan = plan if plan is not None else plan_for(p)
    nc = p.rotations.shape[0]
    npts = p.points.shape[0]
    res, j_c, j_p = _residuals_and_jacobians(p)

    jtj_c = plan.cam.sum(torch.einsum("oki,okj->oij", j_c, j_c))
    g_c = plan.cam.sum(torch.einsum("oki,ok->oi", j_c, res))
    jtj_p = plan.pt.sum(torch.einsum("oki,okj->oij", j_p, j_p))
    g_p = plan.pt.sum(torch.einsum("oki,ok->oi", j_p, res))

    # Camera-point coupling blocks W_{c,j} = sum_{o: cam=c, pt=j} Jc^T Jp,
    # one segment per (point, camera) pair.
    w_o = torch.einsum("oki,okj->oij", j_c, j_p)              # [O, 6, 3]
    a_j = plan.pair.sum(w_o).reshape(npts, nc, 6, 3)
    return jtj_c, g_c, jtj_p, g_p, a_j


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def solve_schur(jtj_c, g_c, jtj_p, g_p, a_j, lm_lambda,
                fix_first_cam: bool = True):
    """Replicated half of the LM step: Schur-complement elimination of the
    point blocks and dense solve of the reduced camera system.
    S = U - sum_j A_j V_j^-1 A_j^T;  rhs = g_c - sum_j A_j V_j^-1 g_p_j."""
    nc = jtj_c.shape[0]
    jtj_c = jtj_c + lm_lambda * _eye(6, jtj_c)[None]
    jtj_p = jtj_p + lm_lambda * _eye(3, jtj_p)[None]
    vinv = torch.linalg.inv_ex(jtj_p).inverse                 # [P, 3, 3]

    av = torch.einsum("pcij,pjk->pcik", a_j, vinv)            # [P,C,6,3]
    s_off = torch.einsum("pcik,pdjk->cidj", av, a_j)          # [C,6,C,6]
    s = torch.block_diag(*jtj_c) - s_off.reshape(nc * 6, nc * 6)
    rhs = (g_c - torch.einsum("pcik,pk->ci", av, g_p)).reshape(-1)

    if fix_first_cam:
        # Gauge fixing: pin camera 0 by zeroing its rows/cols and setting
        # identity on the diagonal.
        mask = torch.cat([torch.zeros(6, dtype=s.dtype, device=s.device),
                          torch.ones(6 * (nc - 1), dtype=s.dtype,
                                     device=s.device)])
        s = s * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        rhs = rhs * mask

    d_cam = -torch.linalg.solve_ex(s, rhs).result.reshape(nc, 6)

    # Back-substitute points: dx_j = -V^-1 (g_p_j + A_j^T dcam)
    at_dc = torch.einsum("pcij,ci->pj", a_j, d_cam)
    d_pt = -torch.einsum("pij,pj->pi", vinv, g_p + at_dc)
    return d_cam, d_pt


def solve_schur_cg(p: BAProblem, lm_lambda, cg_iters: int = 25,
                   fix_first_cam: bool = True,
                   reduce: Optional[Callable] = None,
                   plan: Optional[Plan] = None):
    """LM step via preconditioned CG on the Schur complement, WITHOUT
    forming the [P, C, 6, 3] coupling blocks or the dense [6C, 6C]
    reduced system.  Every S-matvec is computed in observation space:
        S x = (Jc^T Jc + lam I) x - A V^-1 A^T x
        (A^T x)_j = sum_{o: pt=j} W_o^T x_{cam(o)},   W_o = Jc_o^T Jp_o
        (A y)_c   = sum_{o: cam=c} W_o y_{pt(o)}
    ``reduce`` is applied to every observation sum (a cross-device sum
    when the observations are sharded); identity by default.
    Preconditioner: block-Jacobi with the exact 6x6 diagonal blocks of S
    (exact when each (camera, point) pair is observed at most once).
    Fixed ``cg_iters`` iterations, no host synchronisation.

    Returns (d_cam [C, 6], d_pt [P, 3]) like solve_schur."""
    return solve_schur_cg_shards(
        [(p, plan if plan is not None else plan_for(p))], lm_lambda,
        cg_iters, fix_first_cam, reduce)


# A problem whose observation table is split into shards: one
# (BAProblem, Plan) per shard, each on its own device and holding the
# same camera and point parameters.  Every observation sum is each
# shard's partial summed in shard order on the first shard's device (the
# "home", where the camera system is solved), then ``reduce`` (across
# processes: an all_reduce).  One shard and no reduce is the
# single-problem path, bit for bit.
Shards = Sequence[Tuple[BAProblem, Plan]]


def with_params(shards: Shards, rot, tr, pts) -> list:
    """The shards with these camera and point parameters, copied to each
    shard's device."""
    out = []
    for q, plan in shards:
        d = q.cam_idx.device
        out.append((q._replace(rotations=rot.to(d), translations=tr.to(d),
                               points=pts.to(d)), plan))
    return out


def _shard_sum(parts, reduce: Optional[Callable]):
    tot = parts[0]
    for x in parts[1:]:
        tot = tot + x.to(tot.device)
    return tot if reduce is None else reduce(tot)


def shard_cost(shards: Shards, reduce: Optional[Callable] = None):
    """Mean squared reprojection error over all shards' valid
    observations (``_mean_cost`` of the whole table)."""
    num, den = [], []
    for q, _ in shards:
        res, _, _ = _residuals_and_jacobians(q)
        num.append(torch.sum(res * res))
        den.append(torch.sum(q.valid))
    n = torch.clamp(_shard_sum(den, reduce), min=1)
    return _shard_sum(num, reduce) / n


def _mean_cost(p: BAProblem, rot, tr, pts):
    return shard_cost([(p._replace(rotations=rot, translations=tr,
                                   points=pts), None)])


def shard_terms(shards: Shards, reduce: Optional[Callable] = None):
    """``normal_equation_terms`` of the whole table: every term is a sum
    over observations, so the shards' terms are summed."""
    parts = [normal_equation_terms(q, plan) for q, plan in shards]
    return tuple(_shard_sum(list(t), reduce) for t in zip(*parts))


class _ObsTerms(NamedTuple):
    """One shard's per-observation quantities for the CG solve."""

    cam: torch.Tensor
    pt: torch.Tensor
    res: torch.Tensor
    j_c: torch.Tensor
    j_p: torch.Tensor
    plan: Plan
    w_o: torch.Tensor


def solve_schur_cg_shards(shards: Shards, lm_lambda, cg_iters: int = 25,
                          fix_first_cam: bool = True,
                          reduce: Optional[Callable] = None):
    """``solve_schur_cg`` of a sharded problem (see ``Shards``): the
    per-observation work runs on each shard's device, the camera system
    on the home device."""
    nc = shards[0][0].rotations.shape[0]
    obs = []
    for q, plan in shards:
        res, j_c, j_p = _residuals_and_jacobians(q)
        obs.append(_ObsTerms(
            cam=q.cam_idx.to(torch.int64), pt=q.pt_idx.to(torch.int64),
            res=res, j_c=j_c, j_p=j_p, plan=plan,
            w_o=torch.einsum("oki,okj->oij", j_c, j_p)))     # [O, 6, 3]

    def osum(f):
        return _shard_sum([f(o) for o in obs], reduce)

    jtj_c = osum(lambda o: o.plan.cam.sum(
        torch.einsum("oki,okj->oij", o.j_c, o.j_c)))
    g_c = osum(lambda o: o.plan.cam.sum(
        torch.einsum("oki,ok->oi", o.j_c, o.res)))
    jtj_p = osum(lambda o: o.plan.pt.sum(
        torch.einsum("oki,okj->oij", o.j_p, o.j_p)))
    g_p = osum(lambda o: o.plan.pt.sum(
        torch.einsum("oki,ok->oi", o.j_p, o.res)))

    u = jtj_c + lm_lambda * _eye(6, jtj_c)[None]              # [C, 6, 6]
    vinv = torch.linalg.inv_ex(
        jtj_p + lm_lambda * _eye(3, jtj_p)[None]).inverse

    def a_t(x):                       # A^T x: [C, 6] -> [P, 3]
        return osum(lambda o: o.plan.pt.sum(torch.einsum(
            "oij,oi->oj", o.w_o, x.to(o.w_o.device)[o.cam])))

    def a_(y):                        # A y: [P, 3] -> [C, 6]
        return osum(lambda o: o.plan.cam.sum(torch.einsum(
            "oij,oj->oi", o.w_o, y.to(o.w_o.device)[o.pt])))

    gmask = torch.ones((nc, 6), dtype=u.dtype, device=u.device)
    if fix_first_cam:
        gmask[0] = 0.0

    def matvec(x):
        x = x * gmask
        y = torch.einsum("pij,pj->pi", vinv, a_t(x))
        return (torch.einsum("cij,cj->ci", u, x) - a_(y)) * gmask

    # Exact block-diagonal of S (one obs per (cam, pt) pair):
    # S_cc = U_c - sum_{o: cam=c} W_o V_{pt(o)}^-1 W_o^T.
    wvw = osum(lambda o: o.plan.cam.sum(torch.einsum(
        "oij,ojk,olk->oil", o.w_o, vinv.to(o.w_o.device)[o.pt], o.w_o)))
    m_c = u - wvw                                             # [C, 6, 6]
    if fix_first_cam:
        m_c = torch.cat([_eye(6, m_c)[None], m_c[1:]])
    minv = torch.linalg.inv_ex(m_c).inverse

    def prec(r):
        return torch.einsum("cij,cj->ci", minv, r)

    rhs = (g_c - a_(torch.einsum("pij,pj->pi", vinv, g_p))) * gmask

    def dot(a, b):
        return torch.sum(a * b)

    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    x = torch.zeros((nc, 6), dtype=u.dtype, device=u.device)
    r = rhs
    d = prec(rhs)
    rz = dot(rhs, d)
    for _ in range(cg_iters):
        q = matvec(d)
        dq = dot(d, q)
        alpha = torch.where(dq > 0, rz / torch.clamp(dq, min=1e-30), zero)
        x = x + alpha * d
        r = r - alpha * q
        z = prec(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30),
                           zero)
        d = z + beta * d
        rz = rz_new

    d_cam = -x
    d_pt = -torch.einsum("pij,pj->pi", vinv, g_p + a_t(d_cam))
    return d_cam, d_pt


def lm_step(p: BAProblem, lm_lambda, fix_first_cam: bool = True,
            plan: Optional[Plan] = None):
    """One damped Gauss-Newton (LM) step with Schur elimination of points.
    Returns (d_twist [C,6], d_points [P,3])."""
    shards = [(p, plan if plan is not None else plan_for(p))]
    return solve_schur(*shard_terms(shards), lm_lambda, fix_first_cam)


def apply_step(p, d_cam, d_pt):
    """The parameters of ``p`` (a BAProblem or BAState) after the step."""
    dr, dt = se3.se3_exp(d_cam)
    rot = dr @ p.rotations
    tr = (dr @ p.translations[..., None])[..., 0] + dt
    return rot, tr, p.points + d_pt


def lm_iterations(shards: Shards, state: BAState, iterations: int,
                  solver: str = "dense", cg_iters: int = 25,
                  reduce: Optional[Callable] = None) -> BAState:
    """``iterations`` LM iterations of a sharded problem (see ``Shards``)
    from ``state``, which lies on the home device: a damped step
    (``solver`` "dense": Schur reduction and dense camera solve; "cg":
    ``solve_schur_cg_shards``), accepted or rejected by masking with
    ``torch.where`` — no host synchronisation inside.  The body depends
    only on (shards, state), so k calls of n iterations give the bits of
    one call of k*n."""
    for _ in range(iterations):
        q = with_params(shards, state.rotations, state.translations,
                        state.points)
        if solver == "cg":
            d_cam, d_pt = solve_schur_cg_shards(q, state.lm_lambda,
                                                cg_iters=cg_iters,
                                                reduce=reduce)
        else:
            d_cam, d_pt = solve_schur(*shard_terms(q, reduce),
                                      state.lm_lambda)
        rot, tr, pts = apply_step(state, d_cam, d_pt)
        new_cost = shard_cost(with_params(shards, rot, tr, pts), reduce)
        accept = new_cost < state.cost
        lam = torch.where(accept, state.lm_lambda * 0.5,
                          state.lm_lambda * 4.0)
        lam = torch.clamp(lam, 1e-8, 1e4)

        def pick(a, b):
            return torch.where(accept, a, b)

        state = BAState(
            rotations=pick(rot, state.rotations),
            translations=pick(tr, state.translations),
            points=pick(pts, state.points),
            cost=pick(new_cost, state.cost),
            lm_lambda=lam)
    return state


def lm_optimize(p: BAProblem, iterations: int = 10,
                init_lambda: float = 1e-4) -> BAState:
    """Full LM loop: ``lm_iterations`` of the one-shard problem."""
    shards = [(p, plan_for(p))]
    state = BAState(rotations=p.rotations, translations=p.translations,
                    points=p.points, cost=shard_cost(shards),
                    lm_lambda=torch.tensor(init_lambda, dtype=p.points.dtype,
                                           device=p.points.device))
    return lm_iterations(shards, state, iterations)

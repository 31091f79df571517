"""Distributed bundle adjustment: observations sharded over the mesh,
Schur-complement reduction over fixed-order sums.

Counterpart of ``sift_tpu/parallel/dba.py``.  Decomposition:

* The observation table (cam_idx, pt_idx, uv, valid) is split in
  contiguous blocks over the mesh positions — observations are the O(N)
  axis in SfM.  ``place`` pads it with invalid rows to a multiple of the
  mesh size, moves each block to its device and builds its segment plans
  there (one host synchronisation per shard, at set-up).
* Each shard computes its partial of every normal-equation term (each is a
  sum over observations); the partials are summed in shard order on the
  home device (this process's first) and, across processes, all-reduced
  (``geometry/ba.Shards``).  In JAX the same sums are ``psum``s reached in
  lockstep under ``shard_map``; here the fixed order makes the replicated
  ``BAState`` the same bits on every run.
* Two camera-system solvers:
  - ``solver="dense"``: the reduced [6C, 6C] system solved on the home
    device — exact, right for windowed VO BA (tens of cameras);
  - ``solver="cg"``: block-Jacobi-preconditioned CG with observation-space
    S-matvecs (``geometry/ba.solve_schur_cg_shards``) — nothing dense in C
    is ever formed, so global BA scales to thousands of cameras.

The LM loop is ``geometry/ba.lm_iterations``, the one ``lm_optimize``
runs on a single shard.

Elastic recovery: ``make_lm_stepper`` exposes the LM loop as a resumable
(init, step) pair over the replicated BAState; running k chunks of n
iterations is bit-identical to one chunk of k*n (the loop body depends only
on (problem, state)), so a host loop can checkpoint between chunks
(``perf/checkpoint.save_ba_state``) and a restarted cluster resumes
exactly.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from sift_tpu_torch.geometry.ba import (BAProblem, BAState, Plan, Segments,
                                        lm_iterations, shard_cost,
                                        with_params)
from sift_tpu_torch.parallel.batched import Mesh

SOLVERS = ("dense", "cg")


class PlacedProblem(NamedTuple):
    """A problem placed on a mesh: the replicated parameters and
    intrinsics on the home device, and this process's observation
    shards."""

    home: BAProblem
    shards: List[tuple]


def _pad_observations(p: BAProblem, n_shards: int) -> BAProblem:
    """Pad the observation axis to a multiple of the shard count (padding
    rows are invalid and contribute zero)."""
    o = p.cam_idx.shape[0]
    pad = (-o) % n_shards
    if pad == 0:
        return p
    zi = torch.zeros((pad,), dtype=p.cam_idx.dtype, device=p.cam_idx.device)
    return p._replace(
        cam_idx=torch.cat([p.cam_idx, zi]),
        pt_idx=torch.cat([p.pt_idx, zi.to(p.pt_idx.dtype)]),
        uv=torch.cat([p.uv, p.uv.new_zeros((pad, 2))]),
        valid=torch.cat([p.valid, p.valid.new_zeros((pad,))]))


def _reducer(mesh: Mesh):
    if mesh.group is None:
        return None
    from sift_tpu_torch.parallel.multihost import all_reduce_sum
    return lambda x: all_reduce_sum(x, mesh.group)


def make_lm_stepper(mesh: Mesh, axis: str = "data", chunk: int = 5,
                    init_lambda: float = 1e-4, solver: str = "dense",
                    cg_iters: int = 25):
    """Resumable distributed LM: returns (init, step, place).

    ``place(problem) -> PlacedProblem``; ``init(placed) -> BAState``
    (replicated, on the home device); ``step(placed, state) -> BAState``
    runs ``chunk`` LM iterations from ``state`` (which may come from
    ``load_ba_state``, on the host)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} not in {SOLVERS}")
    reduce = _reducer(mesh)
    home_dev = mesh.devices[0]

    def place(p: BAProblem) -> PlacedProblem:
        p = _pad_observations(p, mesh.size)
        nc, npts = p.rotations.shape[0], p.points.shape[0]
        per = p.cam_idx.shape[0] // mesh.size
        lo = mesh.first_position * per
        home = p._replace(rotations=p.rotations.to(home_dev),
                          translations=p.translations.to(home_dev),
                          points=p.points.to(home_dev))
        shards = []
        for i, dev in enumerate(mesh.devices):
            rows = slice(lo + i * per, lo + (i + 1) * per)
            q = home._replace(cam_idx=p.cam_idx[rows].to(dev),
                              pt_idx=p.pt_idx[rows].to(dev),
                              uv=p.uv[rows].to(dev),
                              valid=p.valid[rows].to(dev))
            cam = q.cam_idx.to(torch.int64)
            pt = q.pt_idx.to(torch.int64)
            # The dense solver's coupling blocks need the (point, camera)
            # plan; CG never forms them.
            pair = Segments.build(pt * nc + cam, npts * nc) \
                if solver == "dense" else None
            plan = Plan(cam=Segments.build(cam, nc),
                        pt=Segments.build(pt, npts), pair=pair)
            shards.append((q, plan))
        home = home._replace(cam_idx=None, pt_idx=None, uv=None, valid=None)
        return PlacedProblem(home=home, shards=with_params(
            shards, home.rotations, home.translations, home.points))

    def init(pp: PlacedProblem) -> BAState:
        h = pp.home
        return BAState(
            rotations=h.rotations, translations=h.translations,
            points=h.points, cost=shard_cost(pp.shards, reduce),
            lm_lambda=torch.tensor(init_lambda, dtype=h.points.dtype,
                                   device=home_dev))

    def step(pp: PlacedProblem, state: BAState) -> BAState:
        state = BAState(*[torch.as_tensor(t).to(home_dev) for t in state])
        return lm_iterations(pp.shards, state, chunk, solver, cg_iters,
                             reduce)

    return init, step, place


def make_distributed_lm(mesh: Mesh, axis: str = "data",
                        iterations: int = 10,
                        init_lambda: float = 1e-4, solver: str = "dense",
                        cg_iters: int = 25):
    """Returns (fn, place) where fn(placed) runs the full LM loop with
    observations sharded over the mesh and place(problem) shards a
    BAProblem accordingly."""
    init, step, place = make_lm_stepper(
        mesh, axis, chunk=iterations, init_lambda=init_lambda,
        solver=solver, cg_iters=cg_iters)
    return (lambda pp: step(pp, init(pp))), place

"""Incremental pose graph + pose-graph optimization.

Counterpart of ``sift_tpu/geometry/posegraph.py``.  The graph accumulates
relative-pose constraints into fixed-capacity edge tables; optimization is
batched Gauss-Newton on SE(3) residuals log(Z_ij^-1 * X_j * X_i^-1) with a
dense forward-mode Jacobian, solved densely over the (small) pose axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sift_tpu_torch.geometry import se3
from sift_tpu_torch.pipeline.detector import resolve_device


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph.  Poses are world->camera (R, t);
    edges store the measured relative pose of j in i's frame."""

    rotations: torch.Tensor     # [N, 3, 3]
    translations: torch.Tensor  # [N, 3]
    pose_valid: torch.Tensor    # [N]
    edge_i: torch.Tensor        # [E] int32
    edge_j: torch.Tensor        # [E] int32
    rel_rot: torch.Tensor       # [E, 3, 3]  R_ij: x_j = R_ij x_i + t_ij
    rel_t: torch.Tensor         # [E, 3]
    edge_weight: torch.Tensor   # [E] (0 = invalid)

    @staticmethod
    def empty(n_poses: int, n_edges: int, device=None,
              dtype=torch.float32) -> "PoseGraph":
        eye = torch.eye(3, dtype=dtype, device=device)
        return PoseGraph(
            rotations=eye.expand(n_poses, 3, 3).clone(),
            translations=torch.zeros((n_poses, 3), dtype=dtype,
                                     device=device),
            pose_valid=torch.zeros((n_poses,), dtype=torch.bool,
                                   device=device),
            edge_i=torch.zeros((n_edges,), dtype=torch.int32, device=device),
            edge_j=torch.zeros((n_edges,), dtype=torch.int32, device=device),
            rel_rot=eye.expand(n_edges, 3, 3).clone(),
            rel_t=torch.zeros((n_edges, 3), dtype=dtype, device=device),
            edge_weight=torch.zeros((n_edges,), dtype=dtype, device=device))


def edge_residuals(g: PoseGraph) -> torch.Tensor:
    """[E, 6] residual log(T_meas^-1 * T_j * T_i^-1) per edge — zero when
    pose_j == T_rel ∘ pose_i."""
    ei = g.edge_i.to(torch.int64)
    ej = g.edge_j.to(torch.int64)
    ri, ti = g.rotations[ei], g.translations[ei]
    rj, tj = g.rotations[ej], g.translations[ej]
    # actual relative: T_j * T_i^-1 (maps camera-i coords to camera-j)
    rii, tii = se3.inverse(ri, ti)
    ra, ta = se3.compose(rj, tj, rii, tii)
    # error transform: T_meas^-1 * T_actual
    rmi, tmi = se3.inverse(g.rel_rot, g.rel_t)
    re, te = se3.compose(rmi, tmi, ra, ta)
    w = se3.so3_log(re)
    return torch.cat([te, w], -1)


def optimize(g: PoseGraph, iterations: int = 20,
             damping: float = 1e-6) -> PoseGraph:
    """Batched Gauss-Newton on all poses (pose 0 fixed as gauge).
    Jacobians by forward-mode autodiff of the residual wrt left-increment
    twists — exact, batched over edges.  Fixed iteration count, no host
    synchronisation."""
    n = g.rotations.shape[0]
    dt = g.rotations.dtype
    dev = g.rotations.device

    def residual_of_twists(xi_all, rot, tr):
        dr, dtr = se3.se3_exp(xi_all)
        r2 = dr @ rot
        t2 = (dr @ tr[..., None])[..., 0] + dtr
        return edge_residuals(g._replace(rotations=r2, translations=t2))

    mask = torch.cat([torch.zeros(6, dtype=dt, device=dev),
                      torch.ones(6 * (n - 1), dtype=dt, device=dev)])
    reg = torch.diag((1.0 - mask) + damping * mask)
    w = g.edge_weight[:, None].to(dt)
    zero = torch.zeros((n, 6), dtype=dt, device=dev)
    rot, tr = g.rotations, g.translations
    for _ in range(iterations):
        res0 = residual_of_twists(zero, rot, tr) * w                # [E, 6]
        jac = torch.func.jacfwd(residual_of_twists)(zero, rot, tr)  # [E,6,N,6]
        jac = jac.to(dt) * w[..., None, None]
        jdense = jac.reshape(-1, n * 6)
        h = jdense.T @ jdense
        b = jdense.T @ res0.reshape(-1)
        h = h * mask[:, None] * mask[None, :] + reg
        dx = -torch.linalg.solve_ex(h, b * mask).result.reshape(n, 6)
        dr, dtr = se3.se3_exp(dx)
        rot, tr = dr @ rot, (dr @ tr[..., None])[..., 0] + dtr
    return g._replace(rotations=rot, translations=tr)


class IncrementalPoseGraph:
    """Host-side incremental builder: add keyframes and two-view
    constraints as they arrive (numpy mutation), optimize on a device.
    The device arrays stay fixed-capacity; this wrapper only fills them."""

    def __init__(self, max_poses: int, max_edges: int):
        self.max_poses = max_poses
        self.max_edges = max_edges
        self.n_poses = 0
        self.n_edges = 0
        self._rot = np.tile(np.eye(3, dtype=np.float32), (max_poses, 1, 1))
        self._t = np.zeros((max_poses, 3), np.float32)
        self._ei = np.zeros(max_edges, np.int32)
        self._ej = np.zeros(max_edges, np.int32)
        self._rr = np.tile(np.eye(3, dtype=np.float32), (max_edges, 1, 1))
        self._rt = np.zeros((max_edges, 3), np.float32)
        self._w = np.zeros(max_edges, np.float32)

    def add_pose(self, rot=None, t=None) -> int:
        if self.n_poses >= self.max_poses:
            raise ValueError("pose capacity exceeded")
        i = self.n_poses
        if rot is not None:
            self._rot[i] = rot
            self._t[i] = t
        elif i > 0:
            self._rot[i] = self._rot[i - 1]
            self._t[i] = self._t[i - 1]
        self.n_poses += 1
        return i

    def add_edge(self, i: int, j: int, rel_rot, rel_t, weight=1.0):
        """Constraint: pose_j ≈ (rel_rot, rel_t) ∘ pose_i."""
        if self.n_edges >= self.max_edges:
            raise ValueError("edge capacity exceeded")
        e = self.n_edges
        self._ei[e] = i
        self._ej[e] = j
        self._rr[e] = rel_rot
        self._rt[e] = rel_t
        self._w[e] = weight
        self.n_edges += 1
        # chain initialization of pose j from i when j is the newest pose
        if j == self.n_poses - 1 and self._w[:e][
                (self._ej[:e] == j)].sum() == 0:
            rj = np.asarray(rel_rot) @ self._rot[i]
            tj = (np.asarray(rel_rot) @ self._t[i]) + np.asarray(rel_t)
            self._rot[j] = rj
            self._t[j] = tj

    def to_device(self, device=None) -> PoseGraph:
        """The tables as tensors on ``device`` (None means the GPU and
        raises without one)."""
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.array(a), device=dev)
        return PoseGraph(
            rotations=t(self._rot), translations=t(self._t),
            pose_valid=t(np.arange(self.max_poses) < self.n_poses),
            edge_i=t(self._ei), edge_j=t(self._ej),
            rel_rot=t(self._rr), rel_t=t(self._rt), edge_weight=t(self._w))

    def optimize(self, iterations: int = 20, device=None) -> PoseGraph:
        out = optimize(self.to_device(device), iterations)
        self._rot[:] = out.rotations.cpu().numpy()
        self._t[:] = out.translations.cpu().numpy()
        return out

"""Trajectory evaluation: ATE/RPE metrics with Umeyama alignment, plus
TUM RGB-D and KITTI odometry trajectory file IO.

A copy of the numpy module ``sift_tpu/geometry/trajectory.py`` (the JAX
package cannot be imported without JAX).  The metrics follow the standard
definitions (Sturm et al. TUM RGB-D benchmark): ATE = RMSE of translation
residuals after a best-fit Sim(3)/SE(3) alignment of estimate to ground
truth; RPE = per-step relative-pose error.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Alignment + metrics (numpy; trajectory sizes are tiny)
# ---------------------------------------------------------------------------

def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src/dst: [N, 3].  Returns (s, R, t) with dst ~ s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    r = u @ sgn @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(d) @ sgn) / var_s)
    else:
        s = 1.0
    t = mu_d - s * r @ mu_s
    return s, r, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE, after alignment).  Positions are
    [N, 3] camera centers in matching order."""
    s, r, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (r @ est_positions.T)).T + t
    return float(np.sqrt(((aligned - gt_positions) ** 2).sum(-1).mean()))


def rpe(est_poses: List[np.ndarray], gt_poses: List[np.ndarray],
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over steps of ``delta``.  Poses are 4x4
    camera-to-world.  Returns (trans_rmse, rot_rmse_rad)."""
    terr, rerr = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        ang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(abs(np.arccos(ang)))
    return (float(np.sqrt(np.mean(np.square(terr)))),
            float(np.sqrt(np.mean(np.square(rerr)))))


def positions_from_rt(rotations: np.ndarray,
                      translations: np.ndarray) -> np.ndarray:
    """World camera centers from world->camera (R, t): c = -R^T t."""
    return -np.einsum("nij,nj->ni", np.transpose(rotations, (0, 2, 1)),
                      translations)


# ---------------------------------------------------------------------------
# TUM RGB-D format
# ---------------------------------------------------------------------------

def read_tum_trajectory(path: str):
    """TUM format: `timestamp tx ty tz qx qy qz qw` per line.
    Returns (timestamps [N], poses list of 4x4 cam-to-world)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            ts.append(v[0])
            t = np.array(v[1:4])
            qx, qy, qz, qw = v[4:8]
            r = _quat_to_rot(qx, qy, qz, qw)
            m = np.eye(4)
            m[:3, :3] = r
            m[:3, 3] = t
            poses.append(m)
    return np.array(ts), poses


def write_tum_trajectory(path: str, timestamps, poses):
    with open(path, "w") as f:
        for t, m in zip(timestamps, poses):
            q = _rot_to_quat(m[:3, :3])
            f.write(f"{t:.6f} " + " ".join(
                f"{v:.6f}" for v in list(m[:3, 3]) + list(q)) + "\n")


def associate_timestamps(ts_a, ts_b, max_dt: float = 0.02):
    """Nearest-timestamp association (≙ TUM benchmark associate.py).
    Returns list of (i, j) index pairs, each used at most once."""
    pairs = []
    used_b = set()
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) <= max_dt and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


# ---------------------------------------------------------------------------
# KITTI odometry format
# ---------------------------------------------------------------------------

def read_kitti_trajectory(path: str):
    """KITTI odometry format: 12 floats per line (3x4 cam-to-world).
    Returns list of 4x4 matrices."""
    poses = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) != 12:
                continue
            m = np.eye(4)
            m[:3, :4] = np.array(v).reshape(3, 4)
            poses.append(m)
    return poses


def write_kitti_trajectory(path: str, poses):
    with open(path, "w") as f:
        for m in poses:
            f.write(" ".join(f"{v:.6e}" for v in m[:3, :4].ravel()) + "\n")


def _quat_to_rot(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def _rot_to_quat(r):
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (r[k, j] - r[j, k]) / s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        qx, qy, qz, qw = q
    return [qx, qy, qz, qw]

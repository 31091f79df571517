"""Rendered 3D scenes with ground-truth camera paths, without cv2.

The odometry scenes of the JAX package's tests, drawn with numpy and
torch only (the machine with the card has no cv2), at any frame size:
  * ``render_sequence``: a disc cloud seen from a lateral + forward path
    with slight yaw, optionally in front of a textured backdrop plane
    (tests/test_odometry.py:43-78);
  * ``render_loop_sequence``: the same kind of cloud seen from a path that
    goes out and comes back (tests/test_loop_closure.py:15-46);
  * ``render_corridor``: a forward flythrough of a long corridor, a disc
    cloud between two textured side walls in front of a textured end wall
    (tests/test_odometry.py:140-216, the TUM-format ATE gate's scene).
Discs are filled by a distance mask (cv2.circle's filled integer circle);
the backdrop is ``bench_image`` warped onto the plane by a perspective
``grid_sample`` (bilinear, reflected border), the side walls by the same
warp with a constant border.  The random draws are the tests' own, in
their order, from the same seeds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sift_tpu_torch.perf.benchimg import bench_image


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 H with dst ~ H @ src from four point pairs (as
    cv2.getPerspectiveTransform)."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def warp_perspective(tex: np.ndarray, hmat: np.ndarray, width: int,
                     height: int, border: Optional[float] = None
                     ) -> np.ndarray:
    """cv2.warpPerspective(tex, hmat, (width, height)) with bilinear
    sampling: out(x, y) = tex(hmat^-1 (x, y)).  ``border=None``: a
    reflected border (BORDER_REFLECT_101); a value: a constant border of
    that value (BORDER_CONSTANT), computed exactly as ``tex - border``
    sampled with zero padding, plus ``border``."""
    th, tw = tex.shape
    inv = np.linalg.inv(hmat)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1) @ inv.T
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = pix[..., 0] / pix[..., 2]
        sy = pix[..., 1] / pix[..., 2]
    grid = np.stack([2 * sx / (tw - 1) - 1, 2 * sy / (th - 1) - 1], -1)
    src = torch.from_numpy(tex)[None, None].to(torch.float32)
    if border is None:
        mode = "reflection"
    else:
        # Far outside is outside: keep the horizon's huge (or infinite)
        # coordinates finite for the sampler.
        grid = np.clip(np.nan_to_num(grid, nan=4.0, posinf=4.0,
                                     neginf=-4.0), -4.0, 4.0)
        src, mode = src - border, "zeros"
    out = torch.nn.functional.grid_sample(
        src, torch.from_numpy(grid)[None].to(torch.float32), mode="bilinear",
        padding_mode=mode, align_corners=True)[0, 0]
    return (out if border is None else out + border).numpy()


def _paint_backdrop(r, t, seed, z, ex, ey, fx, width, height, tex_cache):
    """A value-noise textured world plane z = +z (extent +-ex/+-ey) seen
    from camera (r, t)."""
    tex = tex_cache.get(seed)
    if tex is None:
        tex = tex_cache[seed] = bench_image(640, 848, seed=seed)
    th, tw = tex.shape
    corners = np.array([[-ex, -ey, z], [ex, -ey, z],
                        [ex, ey, z], [-ex, ey, z]], np.float64)
    pc = corners @ r.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + width / 2,
                   pc[:, 1] / pc[:, 2] * fx + height / 2], 1)
    src = np.array([[0, 0], [tw, 0], [tw, th], [0, th]], np.float64)
    return warp_perspective(tex, _homography(src, uv), width, height)


def _paint_corridor_walls(img, r, t, center_z, seed, fx, width, height,
                          tex_cache, z_far=80.0, x_half=8.0, y_half=5.0):
    """Two value-noise textured side walls (world planes x = +-x_half,
    z from ``center_z + 1.5`` to ``z_far``) painted over ``img``, the
    texture anchored to the world (u ~ wall z, v ~ wall y).  Each wall is
    warped with a constant border of -1 and copied where the warp is
    >= 0, as the JAX test does with cv2's BORDER_CONSTANT."""
    key = ("walls", seed)
    tex = tex_cache.get(key)
    if tex is None:
        tex = tex_cache[key] = bench_image(512, 2048, seed=seed + 1)
    th, tw = tex.shape
    z0 = center_z + 1.5
    u0 = z0 / z_far * tw
    src = np.array([[u0, 0], [tw, 0], [tw, th], [u0, th]], np.float64)
    for x_w in (-x_half, x_half):
        quad = np.array([[x_w, -y_half, z0], [x_w, -y_half, z_far],
                         [x_w, y_half, z_far], [x_w, y_half, z0]])
        pc = quad @ r.T + t
        uv = np.stack([pc[:, 0] / pc[:, 2] * fx + width / 2,
                       pc[:, 1] / pc[:, 2] * fx + height / 2], 1)
        # cv2.getPerspectiveTransform takes float32 points.
        hmat = _homography(src.astype(np.float32).astype(np.float64),
                           uv.astype(np.float32).astype(np.float64))
        w = warp_perspective(tex, hmat, width, height, border=-1.0)
        np.copyto(img, w, where=w >= 0)
    return img


def _fill_disc(img: np.ndarray, cx: int, cy: int, rad: int,
               val: float) -> None:
    """A filled disc of integer centre and radius (≙ cv2.circle(...,
    thickness=-1))."""
    h, w = img.shape
    y0, y1 = max(cy - rad, 0), min(cy + rad + 1, h)
    x0, x1 = max(cx - rad, 0), min(cx + rad + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    img[y0:y1, x0:x1][m] = val


def _draw_cloud(img, pts, radii, vals, r, t, fx):
    h, w = img.shape
    pc = pts @ r.T + t
    for j in np.argsort(-pc[:, 2]):
        if pc[j, 2] <= 0.5:
            continue
        u = pc[j, 0] / pc[j, 2] * fx + w / 2
        v = pc[j, 1] / pc[j, 2] * fx + h / 2
        rad = max(2, int(radii[j] / pc[j, 2] * fx))
        _fill_disc(img, int(u), int(v), rad, float(vals[j]))


def _pose(ang, center):
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pose = np.eye(4)
    pose[:3, :3] = r.T
    pose[:3, 3] = center
    return r, -r @ center, pose


def render_sequence(n_frames: int = 8, seed: int = 5, n_pts: int = 160,
                    step: float = 1.0, textured: bool = False,
                    width: int = 320, height: int = 240,
                    fx: float = None
                    ) -> Tuple[List[np.ndarray], np.ndarray,
                               List[np.ndarray]]:
    """A disc cloud viewed from a smooth lateral+forward path with slight
    yaw; ``textured``: a value-noise backdrop plane at z=30 behind it.
    Returns (frames float32 [H, W] 0..255, gt camera centres [N, 3],
    cam-to-world 4x4 poses).  ``fx`` defaults to 0.9 * width."""
    fx = 0.9 * width if fx is None else fx
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2.5, 6], [4, 2.5, 16], (n_pts, 3))
    radii = rng.uniform(0.06, 0.3, n_pts)
    vals = rng.uniform(60, 255, n_pts)
    tex_cache = {}
    frames, gt_pos, gt_poses = [], [], []
    for i in range(n_frames):
        center = np.array([-0.22, 0.03, 0.12]) * step * i
        r, t, pose = _pose(0.01 * step * i, center)
        img = (_paint_backdrop(r, t, seed, 30.0, 22.0, 16.0, fx, width,
                               height, tex_cache)
               if textured else np.zeros((height, width), np.float32))
        _draw_cloud(img, pts, radii, vals, r, t, fx)
        img += rng.normal(0, 3, (height, width)).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
        gt_pos.append(center)
        gt_poses.append(pose)
    return frames, np.stack(gt_pos), gt_poses


def render_corridor(n_frames: int = 60, seed: int = 5, n_pts: int = 900,
                    textured: bool = True, width: int = 320,
                    height: int = 240, fx: float = None
                    ) -> Tuple[List[np.ndarray], np.ndarray,
                               List[np.ndarray]]:
    """A forward flythrough of a long corridor: a disc cloud that keeps
    entering the view, ``textured``: in front of a value-noise end wall
    (z=70) between two world-anchored textured side walls.  Returns
    (frames float32 [H, W] 0..255, gt camera centres [N, 3], cam-to-world
    4x4 poses).  ``fx`` defaults to 0.9 * width."""
    fx = 0.9 * width if fx is None else fx
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-8, -5, 2], [8, 5, 60], (n_pts, 3))
    radii = rng.uniform(0.08, 0.35, n_pts)
    vals = rng.uniform(60, 255, n_pts)
    tex_cache = {}
    frames, gt_pos, gt_poses = [], [], []
    for i in range(n_frames):
        center = np.array([0.5 * np.sin(0.1 * i), 0.02 * i, 0.45 * i])
        r, t, pose = _pose(0.05 * np.sin(0.08 * i), center)
        if textured:
            img = _paint_backdrop(r, t, seed, 70.0, 42.0, 32.0, fx, width,
                                  height, tex_cache)
            _paint_corridor_walls(img, r, t, center[2], seed, fx, width,
                                  height, tex_cache)
        else:
            img = np.zeros((height, width), np.float32)
        _draw_cloud(img, pts, radii, vals, r, t, fx)
        img += rng.normal(0, 3, (height, width)).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
        gt_pos.append(center)
        gt_poses.append(pose)
    return frames, np.stack(gt_pos), gt_poses


def render_loop_sequence(n: int = 12, seed: int = 9, n_pts: int = 170,
                         width: int = 320, height: int = 240,
                         fx: float = None
                         ) -> Tuple[List[np.ndarray], np.ndarray]:
    """A disc cloud seen from a camera that translates out for n/2 frames
    and returns near the start (a loop).  Returns (frames, gt centres)."""
    fx = 0.9 * width if fx is None else fx
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2.5, 6], [4, 2.5, 16], (n_pts, 3))
    radii = rng.uniform(0.06, 0.3, n_pts)
    vals = rng.uniform(60, 255, n_pts)
    frames, gt = [], []
    for i in range(n):
        u = i if i < n // 2 else (n - 1 - i)
        center = np.array([-0.22 * u, 0.02 * u, 0.1 * u])
        r, t, _ = _pose(0.008 * u, center)
        img = np.zeros((height, width), np.float32)
        _draw_cloud(img, pts, radii, vals, r, t, fx)
        img += rng.normal(0, 3, (height, width)).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
        gt.append(center)
    return frames, np.stack(gt)


VO_FRAMES = 12
VO_FEATURES = 2000          # tools/odometry.py's default
# The corridor runs as the JAX package's TUM-format CLI gate runs it
# (tests/test_odometry.py:219-257): 60 frames at 320x240, fx = 0.9 * 320.
CORRIDOR_FRAMES = 60
CORRIDOR_WIDTH, CORRIDOR_HEIGHT = 320, 240

# chip_smoke.py's odometry runs by scene: the textured out-and-forward
# sequence at the flagship size with window BA (phase ``vo``) and without
# it (``odometry_cli``), the out-and-back loop (``loop_closure``), and the
# corridor through the CLI with window BA (``corridor``, the JAX test's
# flags).  ``num_features`` is the detector's (``VO_FEATURES`` where it is
# not given); the other keys are ``MonocularOdometry``'s.
ODOMETRY_KW = {
    "textured": dict(ba_interval=3, ba_window=4),
    "textured_no_ba": {},
    "loop": dict(loop_closure=True, kf_interval=2, loop_min_gap=6,
                 loop_min_matches=20, loop_min_inliers=15),
    "corridor": dict(ba_interval=5, ba_window=6, num_features=800),
}


def odometry_settings(name: str) -> Tuple[int, dict]:
    """(the detector's ``num_features``, ``MonocularOdometry``'s keywords)
    of an ``ODOMETRY_KW`` scene."""
    kw = dict(ODOMETRY_KW[name])
    return kw.pop("num_features", VO_FEATURES), kw


def render_scene(name: str, width: int, height: int
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(frames, ground-truth centres) of an ``ODOMETRY_KW`` scene,
    ``VO_FRAMES`` long (the corridor ``CORRIDOR_FRAMES``)."""
    if name == "loop":
        return render_loop_sequence(n=VO_FRAMES, width=width, height=height)
    if name == "corridor":
        frames, gt, _ = render_corridor(n_frames=CORRIDOR_FRAMES,
                                        width=width, height=height)
        return frames, gt
    frames, gt, _ = render_sequence(n_frames=VO_FRAMES, textured=True,
                                    width=width, height=height)
    return frames, gt


def write_pgm(path: str, img: np.ndarray) -> None:
    """An 8-bit binary PGM of ``img`` (clipped, truncated to uint8 as
    cv2.imwrite of ``img.astype(np.uint8)`` stores it)."""
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode())
        fh.write(np.clip(img, 0, 255).astype(np.uint8).tobytes())


# ---------------------------------------------------------------------------
# Bundle-adjustment problems (the JAX tests' generators, without JAX)
# ---------------------------------------------------------------------------


def _so3_exp32(w) -> np.ndarray:
    """Rotation of axis-angle ``w`` computed in float32, as the JAX tests
    do (``se3.so3_exp`` of a float32 array)."""
    from sift_tpu_torch.geometry.se3 import so3_exp
    return so3_exp(torch.as_tensor(np.asarray(w), dtype=torch.float32)
                   ).numpy()


def synthetic_ba(seed: int = 0, n_cams: int = 6, n_pts: int = 120,
                 noise_px: float = 0.0, perturb: float = 0.02,
                 device=None):
    """tests/test_ba.py's ``synthetic_ba``: cameras on an arc looking at a
    point cloud; observations = exact projections + noise; initial
    estimate = ground truth perturbed (camera 0 exact).  Returns
    (float32 BAProblem on ``device``, gt rotations, translations,
    points)."""
    from sift_tpu_torch.core.convert import ba_problem_from_numpy

    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    rots, trs = [], []
    for i in range(n_cams):
        w = np.array([0.0, 0.25 * (i / max(n_cams - 1, 1) - 0.5), 0.0])
        rots.append(_so3_exp32(w))
        trs.append(np.array([-0.8 * i / max(n_cams - 1, 1) + 0.4, 0.0,
                             0.0]))
    rots, trs = np.stack(rots), np.stack(trs)
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        pc = pts @ rots[c].T + trs[c]
        uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                       pc[:, 1] / pc[:, 2] * fy + cy], -1)
        cam_idx += [c] * n_pts
        pt_idx += list(range(n_pts))
        uvs.append(uv + rng.normal(0, noise_px, uv.shape))
    rots_i, trs_i = rots.copy(), trs.copy()
    for c in range(1, n_cams):
        rots_i[c] = _so3_exp32(rng.normal(0, perturb, 3)) @ rots[c]
        trs_i[c] = trs[c] + rng.normal(0, perturb, 3)
    pts_i = pts + rng.normal(0, perturb, pts.shape)
    prob = ba_problem_from_numpy(dict(
        rotations=rots_i.astype(np.float32),
        translations=trs_i.astype(np.float32),
        points=pts_i.astype(np.float32),
        cam_idx=np.asarray(cam_idx, np.int32),
        pt_idx=np.asarray(pt_idx, np.int32),
        uv=np.concatenate(uvs).astype(np.float32),
        valid=np.ones(len(cam_idx), bool), fx=np.float32(fx),
        fy=np.float32(fy), cx=np.float32(cx), cy=np.float32(cy)),
        device=device)
    return prob, rots, trs, pts


def synthetic_ba_chain(seed: int = 0, n_cams: int = 2000,
                       pts_per_cam: int = 2, window: int = 3,
                       perturb: float = 0.01, device=None):
    """tests/test_dba.py's ``synthetic_ba_chain``: a long trajectory,
    cameras on a line, each observing only nearby points (KITTI-like
    sparsity; ~14 observations a camera).  The dense Schur path is
    infeasible at 2000 cameras — the reduced system alone is [12000,
    12000] — which is what ``solver="cg"`` avoids.  Returns a float32
    BAProblem on ``device``."""
    from sift_tpu_torch.core.convert import ba_problem_from_numpy

    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    n_pts = n_cams * pts_per_cam
    px = (np.arange(n_pts) / pts_per_cam) * 0.05 \
        + rng.normal(0, 0.2, n_pts)
    pts = np.stack([px, rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 10, n_pts)], -1)
    centers = np.stack([0.05 * np.arange(n_cams), np.zeros(n_cams),
                        np.zeros(n_cams)], -1)
    rots = np.tile(np.eye(3), (n_cams, 1, 1))
    trs = -centers
    cam_idx, pt_idx = [], []
    for c in range(n_cams):
        lo = max(0, (c - window) * pts_per_cam)
        hi = min(n_pts, (c + window + 1) * pts_per_cam)
        cam_idx += [c] * (hi - lo)
        pt_idx += range(lo, hi)
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    pc = np.einsum("oij,oj->oi", rots[cam_idx], pts[pt_idx]) + trs[cam_idx]
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    trs_i = trs + np.concatenate(
        [np.zeros((1, 3)), rng.normal(0, perturb, (n_cams - 1, 3))])
    pts_i = pts + rng.normal(0, perturb, pts.shape)
    return ba_problem_from_numpy(dict(
        rotations=rots.astype(np.float32),
        translations=trs_i.astype(np.float32),
        points=pts_i.astype(np.float32), cam_idx=cam_idx, pt_idx=pt_idx,
        uv=uv.astype(np.float32), valid=np.ones(len(cam_idx), bool),
        fx=np.float32(fx), fy=np.float32(fy), cx=np.float32(cx),
        cy=np.float32(cy)), device=device)

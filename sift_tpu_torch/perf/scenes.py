"""Rendered 3D scenes with ground-truth camera paths, without cv2.

The odometry scenes of the JAX package's tests, drawn with numpy and
torch only (the machine with the card has no cv2), at any frame size:
  * ``render_sequence``: a disc cloud seen from a lateral + forward path
    with slight yaw, optionally in front of a textured backdrop plane
    (tests/test_odometry.py:43-78);
  * ``render_loop_sequence``: the same kind of cloud seen from a path that
    goes out and comes back (tests/test_loop_closure.py:15-46).
Discs are filled by a distance mask (cv2.circle's filled integer circle,
up to edge pixels); the backdrop is ``bench_image`` warped onto the plane
by a perspective ``grid_sample`` (bilinear, reflected border).  The random
draws are the tests' own, in their order, from the same seeds.
"""

from __future__ import annotations

from typing import List, Tuple

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
                     height: int) -> np.ndarray:
    """cv2.warpPerspective(tex, hmat, (width, height)) with bilinear
    sampling and a reflected border: out(x, y) = tex(hmat^-1 (x, y))."""
    th, tw = tex.shape
    inv = np.linalg.inv(hmat)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1) @ inv.T
    sx = pix[..., 0] / pix[..., 2]
    sy = pix[..., 1] / pix[..., 2]
    grid = np.stack([2 * sx / (tw - 1) - 1, 2 * sy / (th - 1) - 1], -1)
    out = torch.nn.functional.grid_sample(
        torch.from_numpy(tex)[None, None].to(torch.float32),
        torch.from_numpy(grid)[None].to(torch.float32), mode="bilinear",
        padding_mode="reflection", align_corners=True)
    return out[0, 0].numpy()


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

# chip_smoke.py's odometry runs at the flagship size, by scene: the
# textured out-and-forward sequence with window BA (phase ``vo``) and
# without it (``odometry_cli``), and the out-and-back loop (``loop_closure``).
ODOMETRY_KW = {
    "textured": dict(ba_interval=3, ba_window=4),
    "textured_no_ba": {},
    "loop": dict(loop_closure=True, kf_interval=2, loop_min_gap=6,
                 loop_min_matches=20, loop_min_inliers=15),
}


def render_scene(name: str, width: int, height: int
                 ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(frames, ground-truth centres) of an ``ODOMETRY_KW`` scene,
    ``VO_FRAMES`` long."""
    if name == "loop":
        return render_loop_sequence(n=VO_FRAMES, width=width, height=height)
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

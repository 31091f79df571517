"""CLI: two-view (or short-sequence) metric reconstruction — the SfM flow
on top of the feature pipeline.

Counterpart of ``sift_tpu/tools/reconstruct.py`` (same arguments and
printed lines, plus ``--device``): detect+compute per frame ->
ratio-test matching -> vectorized RANSAC on the essential matrix -> pose
recovery + triangulation -> bundle adjustment.  Pair i's RANSAC draws come
from ``torch.Generator().manual_seed(i)`` (the JAX tool: ``jax.random.key
(i)``).  PGM/PPM files decode through the native loader; other formats
need cv2.

Usage: python -m sift_tpu_torch.tools.reconstruct IMG1 IMG2 [IMG...]
       [--fx F] [--fy F] [--cx X] [--cy Y] [--num-features 2000]
       [--ba-iters 10] [--device cuda|cpu]
Intrinsics default to fx=fy=0.9*max(W,H), principal point at the center.
Without --device the GPU is used, and the tool raises if there is none.
``--distributed`` (BA sharded over devices) is not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sift_tpu_torch.pipeline.detector import SiftDetector, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", help="two or more same-size images")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--num-features", type=int, default=2000)
    p.add_argument("--ba-iters", type=int, default=10)
    p.add_argument("--ransac-iters", type=int, default=256)
    p.add_argument("--distributed", action="store_true",
                   help="run BA with observations sharded over all devices "
                        "(not ported yet)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)
    if len(args.images) < 2:
        raise SystemExit("need at least two images")
    if args.distributed:
        raise NotImplementedError(
            "--distributed: the distributed BA (parallel/dba.py) is not "
            "ported yet (ROADMAP A16)")

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.geometry import se3
    from sift_tpu_torch.geometry.ba import BAProblem, _mean_cost, lm_optimize
    from sift_tpu_torch.geometry.twoview import (pixels_to_normalized,
                                                 ransac_essential)
    from sift_tpu_torch.io.image import load_grayscale
    from sift_tpu_torch.pipeline.matcher import match_pairs

    dev = resolve_device(args.device)
    frames = [load_grayscale(f) for f in args.images]
    h, w = frames[0].shape
    fx = args.fx or 0.9 * max(w, h)
    fy = args.fy or fx
    cx = args.cx if args.cx is not None else w / 2
    cy = args.cy if args.cy is not None else h / 2

    det = SiftDetector(SiftConfig(width=w, height=h,
                                  num_features=args.num_features),
                       device=dev)
    results = [det.detect_and_compute(f) for f in frames]
    xys = [torch.stack([r.keypoints.x, r.keypoints.y], -1).cpu().numpy()
           for r in results]
    for i, r in enumerate(results):
        print(f"frame {i}: {int(r.count)} keypoints")

    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    # Pairwise sequential reconstruction: frame 0 is the world frame.
    rots = [np.eye(3, dtype=np.float32)]
    trs = [np.zeros(3, np.float32)]
    cam_idx, pt_idx, uvs = [], [], []
    n_points = 0
    all_points = []
    for i in range(1, len(frames)):
        a, b = results[i - 1], results[i]
        qi, ti = match_pairs(b.descriptors, a.descriptors,
                             b.keypoints.valid, a.keypoints.valid)
        print(f"pair ({i - 1}, {i}): {len(qi)} ratio-test matches")
        pa = xys[i - 1][ti]
        pb = xys[i][qi]
        na = pixels_to_normalized(t(pa), fx, fy, cx, cy)
        nb = pixels_to_normalized(t(pb), fx, fy, cx, cy)
        valid = torch.ones(na.shape[0], dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(i)
        res = ransac_essential(na, nb, valid, gen,
                               n_hypotheses=args.ransac_iters)
        n_inl = int(res.num_inliers)
        rot = res.rotation.cpu().numpy()
        tra = res.translation.cpu().numpy()
        print(f"  essential RANSAC: {n_inl} inliers; "
              f"t = {np.round(tra, 3)}")

        # compose into world frame: pose_i = rel ∘ pose_{i-1}
        rots.append((rot @ rots[i - 1]).astype(np.float32))
        trs.append((rot @ trs[i - 1] + tra).astype(np.float32))

        # triangulated points (camera i-1 frame) -> world.  Gate on
        # cheirality + depth range + reprojection error so degenerate
        # matches (no-parallax pairs, mismatches) never reach BA.
        pts_all = res.points3d.cpu().numpy()
        na_h, nb_h = na.cpu().numpy(), nb.cpu().numpy()
        z1 = pts_all[:, 2]
        pc2 = pts_all @ rot.T + tra
        proj1 = pts_all[:, :2] / np.maximum(z1[:, None], 1e-9)
        proj2 = pc2[:, :2] / np.maximum(pc2[:, 2:], 1e-9)
        e1 = np.linalg.norm(proj1 - na_h, axis=-1) * fx
        e2 = np.linalg.norm(proj2 - nb_h, axis=-1) * fx
        inliers = res.inliers.cpu().numpy()
        inl = (inliers & (z1 > 0.1) & (z1 < 1e3)
               & (pc2[:, 2] > 0.1) & (e1 < 2.0) & (e2 < 2.0))
        print(f"  triangulation gate: {int(inl.sum())} of "
              f"{int(inliers.sum())} inliers kept")
        pts_c = pts_all[inl]
        r_prev_inv, t_prev_inv = se3.inverse(t(rots[i - 1]), t(trs[i - 1]))
        pts_w = se3.transform(r_prev_inv, t_prev_inv,
                              t(pts_c)).cpu().numpy()
        ids = np.arange(n_points, n_points + len(pts_w))
        n_points += len(pts_w)
        all_points.append(pts_w)
        cam_idx += [i - 1] * len(ids) + [i] * len(ids)
        pt_idx += list(ids) * 2
        uvs.append(pa[inl])
        uvs.append(pb[inl])

    points = np.concatenate(all_points).astype(np.float32)
    uv = np.concatenate(uvs).astype(np.float32)
    prob = BAProblem(
        rotations=t(np.stack(rots)), translations=t(np.stack(trs)),
        points=t(points),
        cam_idx=t(np.asarray(cam_idx, np.int64)),
        pt_idx=t(np.asarray(pt_idx, np.int64)),
        uv=t(uv), valid=torch.ones(len(cam_idx), dtype=torch.bool,
                                   device=dev),
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy))

    c0 = float(_mean_cost(prob, prob.rotations, prob.translations,
                          prob.points))
    out = lm_optimize(prob, args.ba_iters)
    mode = "single device"
    print(f"BA ({mode}): mean sq reproj {c0:.4f} -> {float(out.cost):.4f} "
          f"px^2 over {len(cam_idx)} observations, {n_points} points")
    for i in range(len(frames)):
        ang = np.linalg.norm(se3.so3_log(out.rotations[i]).cpu().numpy())
        print(f"pose {i}: |rot| {np.degrees(ang):.2f} deg, "
              f"t {np.round(out.translations[i].cpu().numpy(), 4)}")
    return out


if __name__ == "__main__":
    main()

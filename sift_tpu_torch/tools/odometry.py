"""CLI: monocular visual odometry over an image sequence.

Counterpart of ``sift_tpu/tools/odometry.py`` (same arguments, plus
``--device``): detect+compute on the GPU, device matching, vectorized
RANSAC, PnP tracking, optional windowed BA and loop closure; writes the
estimated trajectory in TUM or KITTI format.  With --gt, reports ATE/RPE
against a ground-truth trajectory file.  A directory of PGM/PPM frames
decodes through the native loader; other formats need cv2.

Usage:
  python -m sift_tpu_torch.tools.odometry DIR --fx F [--fy F --cx X --cy Y]
      [--out traj.txt] [--format tum|kitti] [--gt groundtruth.txt]
      [--ba-interval 5] [--num-features 2000] [--device cuda|cpu]
Without --device the GPU is used, and the tool raises if there is none.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dir", help="directory of same-size frames")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--format", choices=("tum", "kitti"), default="tum")
    p.add_argument("--gt", default=None,
                   help="ground-truth trajectory (same format)")
    p.add_argument("--ba-interval", type=int, default=0)
    p.add_argument("--ba-window", type=int, default=5)
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--kf-interval", type=int, default=4)
    p.add_argument("--loop-min-gap", type=int, default=8)
    p.add_argument("--loop-min-matches", type=int, default=25)
    p.add_argument("--num-features", type=int, default=2000)
    p.add_argument("--telemetry", default=None,
                   help="write per-frame JSONL telemetry to this path")
    p.add_argument("--checkpoint", default=None,
                   help="save the full tracking state to this npz after "
                        "every --checkpoint-interval frames (resume a "
                        "crashed run bit-identically with --resume)")
    p.add_argument("--checkpoint-interval", type=int, default=25)
    p.add_argument("--resume", default=None,
                   help="restore tracking state from a --checkpoint file "
                        "(of either package) before processing")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)

    import numpy as np

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.geometry import trajectory as T
    from sift_tpu_torch.geometry.odometry import MonocularOdometry
    from sift_tpu_torch.io.image import load_image_directory
    from sift_tpu_torch.perf.telemetry import Telemetry

    names, frames = load_image_directory(args.dir)
    if len(frames) < 2:
        raise SystemExit("need at least two frames")
    h, w = frames[0].shape
    fx = args.fx or 0.9 * max(w, h)
    fy = args.fy or fx
    cx = args.cx if args.cx is not None else w / 2
    cy = args.cy if args.cy is not None else h / 2
    print(f"{len(frames)} frames {w}x{h}, fx={fx:.1f}")

    odo = MonocularOdometry(
        SiftConfig(width=w, height=h, num_features=args.num_features),
        fx=fx, fy=fy, cx=cx, cy=cy,
        ba_interval=args.ba_interval, ba_window=args.ba_window,
        loop_closure=args.loop_closure, kf_interval=args.kf_interval,
        loop_min_gap=args.loop_min_gap,
        loop_min_matches=args.loop_min_matches,
        loop_min_inliers=max(10, args.loop_min_matches * 3 // 4),
        telemetry=Telemetry() if args.telemetry else None,
        device=args.device)
    if args.resume:
        odo.load_state(args.resume)
        done = len(odo.result.rotations)
        names, frames = names[done:], frames[done:]
        print(f"resumed at frame {done} from {args.resume}")
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        odo.process(f)
        r = odo.result
        print(f"[{i}] {names[i]}: {r.n_matches[-1]} matches, "
              f"{r.n_inliers[-1]} inliers")
        if args.checkpoint and \
                len(r.rotations) % args.checkpoint_interval == 0:
            odo.save_state(args.checkpoint)
    dt = time.perf_counter() - t0
    print(f"processed {len(frames)} frames in {dt:.2f}s "
          f"({len(frames) / dt:.2f} frames/s incl. first use)")
    if args.telemetry:
        odo.telemetry.write_jsonl(args.telemetry)
        print(f"telemetry written to {args.telemetry}")
    if args.loop_closure:
        print(f"loop closures: {odo.closures}")

    poses = odo.result.poses_cam_to_world()
    if args.out:
        ts = np.arange(len(poses), dtype=float)
        if args.format == "tum":
            T.write_tum_trajectory(args.out, ts, poses)
        else:
            T.write_kitti_trajectory(args.out, poses)
        print(f"trajectory written to {args.out} ({args.format})")

    if args.gt:
        if args.format == "tum":
            _, gt_poses = T.read_tum_trajectory(args.gt)
        else:
            gt_poses = T.read_kitti_trajectory(args.gt)
        n = min(len(poses), len(gt_poses))
        est_p = np.stack([m[:3, 3] for m in poses[:n]])
        gt_p = np.stack([m[:3, 3] for m in gt_poses[:n]])
        ate = T.ate_rmse(est_p, gt_p, with_scale=True)
        t_rpe, r_rpe = T.rpe(poses[:n], gt_poses[:n])
        print(f"ATE (Sim3-aligned RMSE): {ate:.4f}")
        print(f"RPE: trans {t_rpe:.4f}, rot {np.degrees(r_rpe):.3f} deg")
    return odo


if __name__ == "__main__":
    main()

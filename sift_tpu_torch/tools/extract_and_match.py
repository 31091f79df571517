"""CLI: directory sweep with sequential matching (≙ the reference's
tool/extract_and_match_example.cc: per-frame detect+compute, match against
the previous frame's descriptors on the device, optionally draw matches).
Counterpart of ``sift_tpu/tools/extract_and_match.py`` (same arguments,
plus ``--device``).

Usage: python -m sift_tpu_torch.tools.extract_and_match DIR
       [--num-features 2000] [--out-dir DIR] [--ratio 0.8] [--tiers]
       [--device cuda|cpu]

All frames must share frame 0's dimensions (the reference's single-
preallocation contract, extract_and_match_example.cc:57-64).  Runs on the
GPU unless ``--device cpu`` is given; without a GPU and without that flag
it fails.  A directory of PGM/PPM frames decodes through the native loader;
other formats need cv2, and so does ``--out-dir`` (cv2.drawMatches; it
raises ImportError without cv2).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dir", help="directory of same-size images")
    p.add_argument("--num-features", type=int, default=2000)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--out-dir", default=None,
                   help="write drawMatches visualizations here (needs cv2)")
    p.add_argument("--tiers", action="store_true",
                   help="capacity tiers num_features/4 and /2 (those of "
                        "at least 256): each frame runs at the smallest "
                        "tier with 1.5x headroom over the last count")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)

    import os

    import numpy as np

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.io.image import (load_image_directory,
                                         matches_to_cv_dmatches,
                                         to_cv_keypoints)
    from sift_tpu_torch.pipeline.detector import SiftDetector
    from sift_tpu_torch.pipeline.matcher import match_brute_force

    cv2 = None
    if args.out_dir:
        import cv2      # no fallback: the visualisation needs OpenCV

    names, frames = load_image_directory(args.dir)
    if not frames:
        raise SystemExit(f"no images in {args.dir}")
    h, w = frames[0].shape
    cfg = SiftConfig(width=w, height=h, num_features=args.num_features)
    tiers = tuple(t for t in (args.num_features // 4,
                              args.num_features // 2)
                  if t >= 256) if args.tiers else ()
    det = SiftDetector(cfg, tiers=tiers, device=args.device)
    det.warm_up()

    prev_kps = prev_frame = None
    for i, (name, frame) in enumerate(zip(names, frames)):
        t0 = time.perf_counter()
        res = det.detect_and_compute(frame)
        n = int(res.count)
        line = f"[{i}] {name}: {n} kpts"
        if det.prev_result is not None:
            m = match_brute_force(
                res.descriptors, det.prev_result.descriptors,
                res.keypoints.valid, det.prev_result.keypoints.valid,
                ratio=args.ratio).cpu().numpy()
            line += f", {int((m >= 0).sum())} matches to prev"
            if cv2 is not None:
                vis = cv2.drawMatches(
                    frame.astype(np.uint8), to_cv_keypoints(res),
                    prev_frame.astype(np.uint8), prev_kps,
                    matches_to_cv_dmatches(m), None)
                os.makedirs(args.out_dir, exist_ok=True)
                cv2.imwrite(os.path.join(args.out_dir, f"match_{i:04d}.png"),
                            vis)
        line += f" ({(time.perf_counter() - t0) * 1e3:.2f} ms)"
        print(line)
        if cv2 is not None:
            prev_kps = to_cv_keypoints(res)
            prev_frame = frame


if __name__ == "__main__":
    main()

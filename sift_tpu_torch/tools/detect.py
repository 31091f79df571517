"""CLI: single-image detection (≙ the reference's tool/detection_example.cc:
load a grayscale image, run detectAndCompute N times for profiling, optional
golden-checkpoint dump via --debug-path).  Counterpart of
``sift_tpu/tools/detect.py`` (same arguments, plus ``--device``).

Usage: python -m sift_tpu_torch.tools.detect IMAGE [--iters 10]
       [--debug-path DIR] [--num-features 5000] [--upscale] [--profile DIR]
       [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU and without
that flag it fails.  PGM/PPM images decode through the native loader, other
formats need cv2.  Times are wall-clock around each call with the device
synchronised, after one warm-up frame.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image", help="path to an image (read as grayscale)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--debug-path", default=None,
                   help="dump golden checkpoints here (≙ setDataGen)")
    p.add_argument("--num-features", type=int, default=5000)
    p.add_argument("--upscale", action="store_true")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)

    import os

    import numpy as np
    import torch

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.io.image import load_grayscale
    from sift_tpu_torch.pipeline.detector import SiftDetector

    img = load_grayscale(args.image)
    h, w = img.shape
    cfg = SiftConfig(width=w, height=h, num_features=args.num_features,
                     upscale=args.upscale)
    print(f"image {w}x{h}, {cfg.num_octaves} octaves")

    det = SiftDetector(cfg, device=args.device)
    cuda = det.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(det.device)) if cuda \
        else (lambda: None)
    t0 = time.perf_counter()
    det.warm_up()
    print(f"first use (kernel build + warm-up frame): "
          f"{time.perf_counter() - t0:.2f}s")

    if args.debug_path:
        from sift_tpu_torch.perf.checkpoint import capture_golden
        capture_golden(cfg, img, args.debug_path, device=det.device)
        try:
            from sift_tpu_torch.perf.oracle import capture_oracle
            capture_oracle(cfg, img, args.debug_path)
            print(f"golden checkpoint + cv2 oracle written to "
                  f"{args.debug_path}")
        except ImportError:
            print(f"golden checkpoint written to {args.debug_path} "
                  f"(no cv2: oracle skipped)")

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        res = det.detect_and_compute(img)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profile trace in {trace}")

    n = int(res.count)
    print(f"keypoints: {n}")
    print(f"detect+compute: median {np.median(times):.3f} ms "
          f"min {min(times):.3f} ms over {args.iters} iters")


if __name__ == "__main__":
    main()

"""CLI: multi-device scaling efficiency of the keyframe-sharded pipeline.

Counterpart of ``sift_tpu/tools/scale_bench.py`` (same flags and JSON
line).  Measures detect+match throughput of
``parallel/batched.make_sharded_pipeline`` at growing device counts and
prints one JSON line per point:

    {"metric": "scaling", "devices": N, "frames_per_s": F,
     "efficiency_vs_1": E}

Points are ``{1, 2, 4, 8, n}`` up to the ``n`` distinct CUDA devices of
this process (one row on a one-GPU machine).  Frames per device is fixed,
so perfect scaling doubles frames/s per doubling of devices; efficiency =
(F_N / N) / F_1.  One process issues every device's launches here, and a
frame is host-bound, so these rows bound what one process reaches; the
layout that scales is one process per GPU (``parallel/multihost.py``).
``--cpu-mesh N`` runs N CPU shards instead (plumbing only: they run one
after another).  Without it the tool runs on the GPU, and raises if there
is none.

Usage: python -m sift_tpu_torch.tools.scale_bench [--width 752]
           [--height 480] [--num-features 512] [--frames-per-device 2]
           [--iters 4] [--cpu-mesh N]
"""

from __future__ import annotations

import argparse
import json
import time


def measure(mesh, cfg, frames_per_device: int, iters: int) -> float:
    import numpy as np
    import torch

    from sift_tpu_torch.core.types import build_plan
    from sift_tpu_torch.parallel.batched import make_sharded_pipeline
    from sift_tpu_torch.perf.benchimg import bench_image

    fn, shard = make_sharded_pipeline(build_plan(cfg), mesh)
    # Textured frames (distinct seeds), not white noise: the per-keypoint
    # kernels follow the live count, so a noise frame (almost no
    # keypoints) would time an almost empty workload (perf/benchimg.py).
    b = frames_per_device * mesh.size
    frames = np.stack([bench_image(cfg.height, cfg.width, seed=i)
                       for i in range(b)]).astype(np.float32)
    blocks = shard(frames)

    def sync():
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    fn(blocks)                          # first use: kernel load, handles
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(blocks)
        # Synchronise EVERY iteration: waiting on the last call alone
        # measures the enqueue rate, not the computation.
        sync()
    return b * iters / (time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=752)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--num-features", type=int, default=512)
    p.add_argument("--frames-per-device", type=int, default=2)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cpu-mesh", type=int, default=0,
                   help="N CPU shards instead of the GPUs")
    args = p.parse_args(argv)

    import torch

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.parallel.batched import make_mesh

    cfg = SiftConfig(width=args.width, height=args.height,
                     num_features=args.num_features)
    if args.cpu_mesh:
        nd, device = args.cpu_mesh, "cpu"
    else:
        nd, device = len(make_mesh().devices), None
    points = sorted({1, 2, 4, 8, nd} & set(range(1, nd + 1)))
    base = None
    rows = []
    for n in points:
        fps = measure(make_mesh(n, device=device), cfg,
                      args.frames_per_device, args.iters)
        if base is None:
            base = fps
        rows.append({"metric": "scaling", "devices": n,
                     "frames_per_s": round(fps, 3),
                     "efficiency_vs_1": round(fps / (n * base), 4)})
        print(json.dumps(rows[-1]), flush=True)
    if device is None:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "device_count": torch.cuda.device_count()}),
              flush=True)
    return rows


if __name__ == "__main__":
    main()

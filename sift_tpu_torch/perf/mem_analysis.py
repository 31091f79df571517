"""Device memory of one detector frame at the reference's sizes.

Counterpart of ``scripts/mem_analysis.py`` (same sizes, flags and JSON
keys).  The JAX script reads XLA's compiled-program memory analysis; here
the frame is measured on the card: after one warm frame, the memory
allocated before a second frame (the detector's operators moved to the
device once, the input frame, and what first use keeps, such as cuBLAS's
workspace) is ``args_mib``, the result's tensors
``output_mib``, and what the frame's peak (``torch.cuda.
max_memory_allocated`` after ``reset_peak_memory_stats``) holds beyond
both is ``temp_mib``.  One JSON line per size:

    {"metric": "memory", "size": "752x480", "temp_mib": T,
     "args_mib": A, "output_mib": O, "total_mib": T + A + O}

Needs a CUDA device and raises without one.

Usage: python -m sift_tpu_torch.perf.mem_analysis [WxH ...]
           [--num-features N]
"""

from __future__ import annotations

import argparse
import json

import torch

MIB = 1024.0 * 1024.0


def frame_memory(width: int, height: int, num_features: int) -> dict:
    """The memory line of one warmed detector frame at ``width`` x
    ``height`` on the current CUDA device."""
    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.core.types import build_plan
    from sift_tpu_torch.perf.benchimg import bench_image
    from sift_tpu_torch.pipeline.detector import build_detect_fn

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated(dev)
    cfg = SiftConfig(width=width, height=height, num_features=num_features)
    fn = build_detect_fn(build_plan(cfg), device=dev)
    img = torch.as_tensor(bench_image(height, width), device=dev)
    fn(img)                       # warm: kernel load, cuBLAS workspace
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated(dev) - start
    torch.cuda.reset_peak_memory_stats(dev)
    res = fn(img)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - start
    out = sum(t.numel() * t.element_size()
              for t in (*res.keypoints, res.descriptors, res.count,
                        res.raw_count))
    temp = peak - args - out
    return {"metric": "memory", "size": f"{width}x{height}",
            "temp_mib": temp / MIB, "args_mib": args / MIB,
            "output_mib": out / MIB, "total_mib": (temp + args + out) / MIB}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sizes", nargs="*",
                   default=["752x480", "1600x900", "1920x1200"])
    p.add_argument("--num-features", type=int, default=5000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("mem_analysis measures device memory and needs a "
                           "CUDA device; none is available")
    lines = []
    for s in args.sizes:
        w, h = map(int, s.split("x"))
        lines.append(frame_memory(w, h, args.num_features))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()

"""Where one frame's time goes on the GPU.

    python -m sift_tpu_torch.perf.profile [--out FILE.json]

Runs ``SiftDetector.detect_and_compute`` on the 752x480 benchmark image
(``num_features=5000``) for 10 frames under ``torch.profiler`` and prints
one JSON object:
frame time on the host clock, the device's busy time per frame (sum of all
kernel and memcpy durations), its idle share, the number of device kernels
per frame, the device time of the package's own kernels and of the
matrix products, and the device time by kernel name (top 25).  Needs a CUDA
device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


FRAMES = 10
_OWN = ("detect_records_kernel", "expand_lane_copies_kernel",
        "orientation_hist_kernel", "descriptor_hist_kernel",
        "gather_windows_kernel")


def device_rows(prof, calls: int):
    """(kernel name, device ms per call, launches per call) of a finished
    ``torch.profiler`` run, largest first.  Device rows only: the
    host-side aten:: rows repeat the time of the kernels they launched."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us / calls / 1e3, e.count / calls))
    rows.sort(key=lambda r: -r[1])
    return rows


def device_ms(fn, calls: int = 10, name: str = ""):
    """Device time of one call of ``fn``: the summed durations of the
    kernels and copies it puts on the card whose name contains ``name``
    (all of them by default), from ``torch.profiler`` over ``calls`` calls
    (after two warm-up calls).  None if the profiler saw no such device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in device_rows(prof, calls) if name in r[0]]
    return sum(r[1] for r in rows) if rows else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.perf.benchimg import (FLAGSHIP_FEATURES,
                                              FLAGSHIP_HEIGHT,
                                              FLAGSHIP_WIDTH, bench_image)

    width, height, frames = FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT, FRAMES
    det = SiftDetector(SiftConfig(width=width, height=height,
                                  num_features=FLAGSHIP_FEATURES))
    img = torch.as_tensor(bench_image(height, width, seed=0),
                          device=det.device)
    det.warm_up()
    for _ in range(3):
        det.detect_and_compute(img)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(frames):
        res = det.detect_and_compute(img)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / frames * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            det.detect_and_compute(img)
        torch.cuda.synchronize()
    rows = device_rows(prof, frames)
    busy_ms = sum(r[1] for r in rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {
        "card": smi, "torch": torch.__version__,
        "width": width, "height": height,
        "num_features": FLAGSHIP_FEATURES, "frames": frames,
        "keypoints": int(res.count),
        "frame_wall_ms": wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "device_kernels_per_frame": sum(r[2] for r in rows),
        "device_time_measured": bool(rows),
        "gemm_ms_per_frame": sum(ms for k, ms, _ in rows if "gemm" in k),
        "own_kernels": [{"name": k.split("(")[0], "ms_per_frame": ms,
                         "calls_per_frame": n} for k, ms, n in rows
                        if k.startswith(_OWN)],
        "top_kernels": [{"name": k[:100], "ms_per_frame": ms,
                         "calls_per_frame": n} for k, ms, n in rows[:25]],
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

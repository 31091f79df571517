"""Where one frame's time goes on the GPU.

    python -m sift_tpu_torch.perf.profile [--size WxH] [--num-features N]
        [--out FILE.json]

Runs ``SiftDetector.detect_and_compute`` on the benchmark image (default
752x480, ``num_features=5000``) for 10 frames under ``torch.profiler``
and prints one JSON object:
frame time on the host clock, the device's busy time per frame (sum of all
kernel and memcpy durations), its idle share, the number of device kernels
per frame, the device time of the package's own kernels and of the
matrix products, the device time by kernel name (top 25), and the host and
device time a frame of each of the program's ``sift.*`` spans.  Needs a
CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from sift_tpu_torch.perf.benchimg import (FLAGSHIP_FEATURES, FLAGSHIP_HEIGHT,
                                          FLAGSHIP_WIDTH, bench_image)

FRAMES = 10
PROFILE_ATTEMPTS = 3
_OWN = ("detect_records_kernel", "expand_lane_copies_kernel",
        "orientation_hist_kernel", "descriptor_hist_kernel",
        "gather_windows_kernel")


def device_rows(prof, calls: int):
    """(kernel name, device ms per call, launches per call) of a finished
    ``torch.profiler`` run, largest first.  Device rows only: the
    host-side aten:: rows repeat the time of the kernels they launched,
    and a range's device-side copy (``gpu_user_annotation``) the time of
    the kernels inside it."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
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
    (after two warm-up calls).  A profile that records no such device
    activity is taken again, up to ``PROFILE_ATTEMPTS`` profiles in all
    (the profiler has come back empty now and then for a kernel it saw in
    the same process before and after); None if none of them saw any."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in device_rows(prof, calls) if name in r[0]]
        if rows:
            return sum(r[1] for r in rows)
    return None


def span_rows(prof, calls: int):
    """[{span, calls, host_ms, device_ms} per call] of every ``sift.*``
    span in a finished ``torch.profiler`` run, in the order each first
    opened: ``host_ms`` the span's length on the host, ``device_ms`` the
    device time of the kernels and copies whose launch (a CUDA API call,
    found by correlation id in the exported trace) lies inside it, its
    nested spans' included.  Read from the trace: the profiler's own tree
    attaches no kernel that the package launches with ``cuLaunchKernel``
    (K1, K5, K2, K3) to an enclosing range."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                    e.get("tid")) for e in events
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("sift."))
    acc = {}
    for s, t, name, _ in spans:
        n, host, dev = acc.get(name, (0, 0.0, 0.0))
        acc[name] = (n + 1, host + t - s, dev)
    launched = {}                   # correlation id -> enclosing spans
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            launched[corr] = {name for s, t, name, tid in spans
                              if s <= e["ts"] <= t and tid == e.get("tid")}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            for name in launched.get(corr, ()):
                n, host, dev = acc[name]
                acc[name] = (n, host, dev + e.get("dur", 0))
    return [{"span": k, "calls": n / calls, "host_ms": h / calls / 1e3,
             "device_ms": d / calls / 1e3}
            for k, (n, h, d) in acc.items()]


def frame_profile(det, img, frames: int = FRAMES) -> dict:
    """Where ``frames`` calls of ``det.detect_and_compute(img)`` spend
    their time on the card, after three warm frames: the host clock per
    frame, then the same frames again under ``torch.profiler`` for the
    device's busy time (sum of all kernel and copy durations), its idle
    share against the host clock, the device kernels per frame, the
    matrix products' and the package's own kernels' device time, the 25
    largest rows by kernel name, and the program's spans (``span_rows``,
    a frame each)."""
    from torch.profiler import ProfilerActivity, profile

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
    return {
        "frames": frames, "keypoints": int(res.count),
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
        "spans": span_rows(prof, frames),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", default=f"{FLAGSHIP_WIDTH}x{FLAGSHIP_HEIGHT}",
                    help="frame WxH")
    ap.add_argument("--num-features", type=int, default=FLAGSHIP_FEATURES)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA device", file=sys.stderr)
        return 1
    from sift_tpu_torch import SiftConfig, SiftDetector

    width, height = (int(v) for v in args.size.split("x"))
    det = SiftDetector(SiftConfig(width=width, height=height,
                                  num_features=args.num_features))
    img = torch.as_tensor(bench_image(height, width, seed=0),
                          device=det.device)
    det.warm_up()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "torch": torch.__version__,
           "width": width, "height": height,
           "num_features": args.num_features,
           **frame_profile(det, img)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

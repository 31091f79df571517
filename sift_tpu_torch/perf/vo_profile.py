"""Where a visual-odometry frame's time goes on the GPU.

    python -m sift_tpu_torch.perf.vo_profile [--out FILE.json]

Runs ``MonocularOdometry`` (window BA every 3rd frame, ``num_features=
2000``) over the rendered 752x480 textured sequence that ``chip_smoke.py``'s
``vo`` phase gates, and profiles two windows with ``torch.profiler``: the
bootstrap frame (essential RANSAC) and three PnP-tracked frames (2-4, one
with window BA).  For each window it prints one JSON object: host ms per
frame, device busy ms and idle share, device kernels per frame, host
synchronisations per frame (``cudaStreamSynchronize`` /
``cudaDeviceSynchronize`` and device-to-host copies), the top device
kernels and the top host operators by self CPU time.  Needs a CUDA device;
fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

WIDTH, HEIGHT = 752, 480
_SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _window(prof, frames: int, wall_ms: float) -> dict:
    from torch.autograd import DeviceType

    from sift_tpu_torch.perf.profile import device_rows

    rows = device_rows(prof, frames)
    busy = sum(r[1] for r in rows)
    host = []
    syncs = d2h = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            continue
        if e.key in _SYNC:
            syncs += e.count
        host.append((e.key, e.self_cpu_time_total / frames / 1e3,
                     e.count / frames))
        if e.key == "cudaMemcpyAsync":
            d2h += e.count
    host.sort(key=lambda r: -r[1])
    return {
        "frames": frames, "host_ms_per_frame": wall_ms / frames,
        "device_busy_ms_per_frame": busy,
        "device_idle_share": 1.0 - busy / (wall_ms / frames),
        "device_kernels_per_frame": sum(r[2] for r in rows),
        "syncs_per_frame": syncs / frames,
        "memcpy_calls_per_frame": d2h / frames,
        "top_kernels": [{"name": k[:90], "ms_per_frame": ms,
                         "calls_per_frame": n} for k, ms, n in rows[:12]],
        "top_host_ops": [{"name": k[:60], "self_cpu_ms_per_frame": ms,
                          "calls_per_frame": n} for k, ms, n in host[:25]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vo_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.geometry.odometry import MonocularOdometry
    from sift_tpu_torch.perf import scenes

    frames, _ = scenes.render_scene("textured", WIDTH, HEIGHT)
    fx = 0.9 * WIDTH
    odo = MonocularOdometry(SiftConfig(width=WIDTH, height=HEIGHT,
                                       num_features=scenes.VO_FEATURES),
                            fx=fx, fy=fx, cx=WIDTH / 2, cy=HEIGHT / 2,
                            **scenes.ODOMETRY_KW["textured"])
    odo.detector.warm_up()
    odo.process(frames[0])
    torch.cuda.synchronize()
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0],
        "torch": torch.__version__, "width": WIDTH, "height": HEIGHT,
        "num_features": scenes.VO_FEATURES}
    for name, idx in (("bootstrap", [1]), ("pnp", [2, 3, 4])):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in idx:
                odo.process(frames[i])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        out[name] = _window(prof, len(idx), wall)
        out[name]["modes"] = odo.result.modes[idx[0]:idx[-1] + 1]
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

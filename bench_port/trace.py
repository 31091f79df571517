"""The device trace of a short steady span of the window.

``torch.profiler`` records the span; its Chrome trace is read back and
turned into what the per-layer readers need: every kernel with its device
interval and the benchmark range (``bench.*``, ``record_function``) from
which the host launched it, the device's busy time (the union of kernel,
copy and memset intervals), the span's length, the device operations that
took most time and the device's idle gaps by the range the host was in.

The launch of a kernel is found through its correlation id; a kernel whose
launch the trace lacks takes the range of the kernel before it on the
device (one stream, so one range's kernels run in a row).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

BENCH_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Parsed trace: ``kernels`` [(name, start_us, end_us, range)],
    ``busy_s``, ``window_s``, ``device_ops``, ``idle_gaps``."""

    def __init__(self, events):
        ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                        for e in events
                        if e.get("cat") == "user_annotation"
                        and str(e.get("name", "")).startswith(BENCH_PREFIX))
        starts = [r[0] for r in ranges]

        def range_at(ts):
            # The benchmark's ranges follow one another, never nest.
            i = bisect.bisect_right(starts, ts) - 1
            return ranges[i][2] if i >= 0 and ranges[i][1] >= ts else None

        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
        dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                      e["cat"], e.get("args", {}).get("correlation"))
                     for e in events if e.get("cat") in DEVICE_CATS)
        # Work launched before the profile began (still on the device when
        # it started) belongs to no range of the span: the span begins at
        # the first activity launched inside one.
        where = [range_at(launch[c]) if c in launch else None
                 for *_, c in dev]
        first = next((i for i, w in enumerate(where) if w), len(dev))
        dev, where = dev[first:], where[first:]
        for i in range(1, len(where)):
            where[i] = where[i] or where[i - 1]
        self.kernels = [(name, s, t, w) for (s, t, name, cat, _), w
                        in zip(dev, where) if cat == "kernel"]
        # Union of device intervals and the gaps between them.
        merged = []
        for s, t, *_ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-6
        self.window_s = (merged[-1][1] - merged[0][0]) * 1e-6 if merged \
            else 0.0
        gaps = collections.Counter()
        for (_, t), (s, _) in zip(merged, merged[1:]):
            gaps[range_at(t) or "outside bench ranges"] += (s - t) * 1e-6
        ops = collections.Counter()
        for s, t, name, *_ in dev:
            ops[name] += (t - s) * 1e-6
        self.device_ops = [[n, v] for n, v in ops.most_common(10)]
        self.idle_gaps = [[n, v] for n, v in gaps.most_common(10)]

    def kernel_time_s(self, name_part=None, where=None) -> float:
        return sum(t - s for n, s, t, w in self.kernels
                   if (name_part is None or name_part in n)
                   and (where is None or w == where)) * 1e-6

    def kernel_count(self, name_part=None, where=None) -> int:
        return sum(1 for n, s, t, w in self.kernels
                   if (name_part is None or name_part in n)
                   and (where is None or w == where))

    def has_kernels(self, names=()) -> bool:
        return bool(self.kernels) and all(
            any(part in n for n, *_ in self.kernels) for part in names)


def warm_up() -> None:
    """Start and stop the profiler once: its first start initialises the
    device tracing, which takes seconds and belongs to set-up."""
    stop(start())


def start():
    """A running profiler of the CPU and CUDA activities."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> Trace:
    """Stop ``prof`` and parse its trace (written to a temporary file
    under ``TMPDIR`` and removed)."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)

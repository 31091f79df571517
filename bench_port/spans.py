#!/usr/bin/env python3
"""The program's own spans in a profiler trace, and what they show.

The port opens ``record_function`` ranges named ``sift.*`` while a
profiler runs (``sift_tpu_torch/perf/telemetry.py``): ``sift.detect`` over
its stages ``sift.detect.{pyramid, records, walk, compact, orientation,
expand, descriptor}``, and ``sift.match`` over ``sift.match.{gram,
select, count}``.  ``Program(events)`` reads them from a Chrome trace's
events: the kernels, and their device time, by the innermost span whose
host code launched them (correlation ids); host time and self time by
span; the device's idle gaps by the innermost span the host was in when
each gap opened (``trace.Trace.idle_gaps``' convention, over the same
device activity); host time in CUDA API calls by span.  A
trace without the program's spans (a parent commit) parses to an empty
``Program``, and every reading of it is None.

The harness's ``Trace`` keeps the benchmark's ``bench.*`` ranges alone and
drops the events once parsed, so a reader under ``metrics/`` cannot reach
these spans; ``live_share``, which reads the program's counters, is the
reader of ``match_live_share.frames`` and ``.pairs``.  The span readings
are taken by this file's command, which runs one cell as ``run.py
--trace 1`` does and parses the same profile's events here as well:

    python3 bench_port/spans.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

It prints the run's result line with ``spans`` (each span's calls, host
ms, self ms, kernels, device ms, idle ms and runtime ms, a profiled unit
each) and ``span_metrics``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import json
import os
import sys
import time
from pathlib import Path
from unittest import mock

PREFIX = "sift."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BENCH_PREFIX = "bench."
# K1, K5, K2 and K3: the detector's hand-written kernels.
OWN_KERNELS = ("detect_records", "expand_lane_copies", "orientation_hist",
               "descriptor_hist")


class _Ranges:
    """Properly nested host ranges: the innermost one open at a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)          # (start, end, name, tid)
        self.starts = [r[0] for r in self.ranges]

    def at(self, ts, tid=None):
        """Name of the latest-opened range that holds ``ts`` (on thread
        ``tid`` if given), or None."""
        for i in range(bisect.bisect_right(self.starts, ts) - 1, -1, -1):
            s, e, name, t = self.ranges[i]
            if e >= ts and (tid is None or t == tid):
                return name
        return None


class Program:
    """The ``sift.*`` spans of a trace.  By span name: ``calls``,
    ``host_us``, ``self_us``, ``device_us`` (kernels), ``kernel_count``,
    ``idle_us``, ``runtime_us``; ``kernels`` [(name, start, end, span)];
    times in microseconds, the trace's unit."""

    def __init__(self, events):
        mine = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"], e.get("tid"))
                for e in events if e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PREFIX)]
        spans = _Ranges(mine)
        bench = _Ranges((e["ts"], e["ts"] + e.get("dur", 0), e["name"], None)
                        for e in events if e.get("cat") == "user_annotation"
                        and str(e.get("name", "")).startswith(BENCH_PREFIX))
        self.calls = collections.Counter(n for *_, n, _ in mine)
        self.host_us = collections.Counter()
        self.self_us = collections.Counter()
        stack = []
        for s, e, name, tid in sorted(mine, key=lambda r: (str(r[3]), r[0],
                                                            -r[1])):
            while stack and (stack[-1][3] != tid or stack[-1][1] < e):
                stack.pop()
            self.host_us[name] += e - s
            self.self_us[name] += e - s
            if stack:
                self.self_us[stack[-1][2]] -= e - s
            stack.append((s, e, name, tid))

        launch, self.runtime_us = {}, collections.Counter()
        for e in events:
            if e.get("cat") in RUNTIME_CATS:
                where = spans.at(e["ts"], e.get("tid"))
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = (e["ts"], where)
                if where:
                    self.runtime_us[where] += e.get("dur", 0)
        dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                      e["cat"], e.get("args", {}).get("correlation"))
                     for e in events if e.get("cat") in DEVICE_CATS)
        # The device activity ``Trace`` keeps: from the first launched in
        # a benchmark range (or, in a trace without them, in a span).
        first_in = bench.at if bench.ranges else spans.at
        first = next((i for i, d in enumerate(dev) if d[4] in launch
                      and first_in(launch[d[4]][0])), len(dev))
        dev = dev[first:]
        where = [launch[c][1] if c in launch else None for *_, c in dev]
        for i in range(1, len(where)):
            if dev[i][4] not in launch:
                where[i] = where[i - 1]
        self.kernels = [(name, s, t, w) for (s, t, name, cat, _), w
                        in zip(dev, where) if cat == "kernel"]
        self.device_us = collections.Counter()
        self.kernel_count = collections.Counter()
        for _, s, t, w in self.kernels:
            if w:
                self.device_us[w] += t - s
                self.kernel_count[w] += 1
        merged = []
        for s, t, *_ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.idle_us = collections.Counter()
        for (_, t), (s, _) in zip(merged, merged[1:]):
            w = spans.at(t)
            if w:
                self.idle_us[w] += s - t

    def table(self, units: int) -> dict:
        """Each span's numbers a unit (ms): calls, host, self, kernels,
        device, idle and runtime."""
        return {n: {"calls": self.calls[n] / units,
                    "host_ms": self.host_us[n] * 1e-3 / units,
                    "self_ms": self.self_us[n] * 1e-3 / units,
                    "kernels": self.kernel_count[n] / units,
                    "device_ms": self.device_us[n] * 1e-3 / units,
                    "idle_ms": self.idle_us[n] * 1e-3 / units,
                    "runtime_ms": self.runtime_us[n] * 1e-3 / units}
                for n in sorted(self.calls)}


def _in(span, top):
    return span == top or str(span).startswith(top + ".")


def _per_call(p: Program, top: str, us: float):
    return us * 1e-3 / p.calls[top] if p.calls[top] else None


def detect_glue_ms(p: Program):
    """Device ms a frame of the kernels launched in ``sift.detect.*``
    other than K1, K5, K2 and K3."""
    return _per_call(p, "sift.detect", sum(
        t - s for n, s, t, w in p.kernels if _in(w, "sift.detect")
        and not any(k in n for k in OWN_KERNELS)))


def detect_idle_ms(p: Program):
    """Device idle ms a frame in gaps that open while the host is inside
    ``sift.detect``."""
    return _per_call(p, "sift.detect", sum(
        v for w, v in p.idle_us.items() if _in(w, "sift.detect")))


def detect_launch_wait_ms(p: Program):
    """Host ms a frame inside ``sift.detect`` spent in CUDA API calls
    (the trace's ``cuda_runtime`` and ``cuda_driver`` events)."""
    return _per_call(p, "sift.detect", sum(
        v for w, v in p.runtime_us.items() if _in(w, "sift.detect")))


def match_stage_ms(p: Program, stage: str):
    """Device ms a matcher call of the kernels launched in
    ``sift.match.<stage>``."""
    return _per_call(p, "sift.match", p.device_us["sift.match." + stage])


def span_metrics(p: Program) -> dict:
    """The span readings by the metric names they would go under."""
    return {"detect_glue_ms": detect_glue_ms(p),
            "detect_idle_ms": detect_idle_ms(p),
            "detect_launch_wait_ms": detect_launch_wait_ms(p),
            "match_gram_ms": match_stage_ms(p, "gram"),
            "match_select_ms": match_stage_ms(p, "select"),
            "match_count_ms": match_stage_ms(p, "count")}


def live_share(ctx):
    """The share of the matcher's distance entries that pair a live query
    row with a live train row, in percent: the program's counter
    ``match.live_entries`` over ``match.entries``, over the calls it
    profiled.  None where the program keeps no such counters or the
    trace holds no kernel of the benchmark's ``match`` range."""
    try:
        tel = importlib.import_module(ctx.stream.prog.__name__
                                      + ".perf.telemetry")
    except ImportError:
        return None
    read = getattr(tel, "program_counters", None)
    if read is None or ctx.trace.kernel_time_s(where="bench.match") <= 0:
        return None
    c = read()
    n = c.get("match.entries", 0)
    return 100.0 * c.get("match.live_entries", 0) / n if n else None


def main(argv=None) -> int:
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(root))
    os.environ["SIFT_TPU_TORCH_BUILD_DIR"] = str(root / "build"
                                                 / "sift_tpu_torch")
    import torch

    from bench_port import measure, spec
    from bench_port import trace as tr

    if not torch.cuda.is_available():
        print("spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    kept = []

    class Kept(tr.Trace):
        def __init__(self, events):
            super().__init__(events)
            kept.append((self, Program(events)))

    cell = spec.load_cell(args.workload)
    with mock.patch.object(tr, "Trace", Kept):
        out, _ = measure.run_cell(cell, args.seed, args.seconds, True,
                                  "cuda", t_start)
    # The harness reads the last profile; so do these readings.
    units = int(cell.params["trace_units"])
    if len(kept) > 1:
        t, p = kept[-1]
        out["spans"] = p.table(units)
        out["span_metrics"] = span_metrics(p)
        out["bench_kernel_ms"] = {
            w: t.kernel_time_s(where=w) * 1e3 / units
            for w in ("bench.detect", "bench.match")}
    text = json.dumps(out)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

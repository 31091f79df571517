"""Structured telemetry — counters, timers, and per-frame event records.

A copy of the numpy-free module ``sift_tpu/perf/telemetry.py`` (the JAX
package cannot be imported without JAX).  A ``Telemetry`` sink collects
typed events and scalar series, exposes summaries, and serializes to
JSON-lines; ``MonocularOdometry(telemetry=...)`` emits one event per
frame (mode, matches, inliers, landmark/keyframe counts, loop closures,
BA activity), ``tools/odometry.py --telemetry PATH`` writes the stream.

The program's own spans and counters live here too, and exist only while
``torch.profiler`` runs (``tracing()``): ``span(name)`` is then a
``record_function`` range, a ``user_annotation`` in the same trace as the
kernels it launches (their correlation ids tie each kernel to it), and at
any other time one shared no-op context.  ``count`` (a host number) and
``count_device`` (a 0-d device tensor, added on the device with no
synchronisation) move process-wide counters, again only while tracing;
``program_counters()`` reads them all after the work.  The detector opens
``sift.detect`` and its stages ``sift.detect.{pyramid, records, walk,
compact, orientation, expand, descriptor}``; the matcher ``sift.match``
over ``sift.match.fused`` (uint8 descriptors on the card: its kernel's
launches) or ``sift.match.{gram, select}`` (the plain path), then
``sift.match.count``, and counts ``match.entries``,
``match.live_entries`` and, once a call that took the kernel,
``match.kernel_calls``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch


class Telemetry:
    """In-memory event/series sink with JSONL export.

    Events: ``emit(kind, **fields)`` appends a typed record stamped with
    a monotonic timestamp.  Series: ``record(name, value)`` appends to a
    named scalar series (summary() gives count/mean/min/max).  Timers:
    ``with tel.timer("stage"):`` records wall seconds into a series."""

    def __init__(self):
        self.events: List[Dict] = []
        self.series: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    def emit(self, kind: str, **fields):
        rec = {"t": round(time.perf_counter() - self._t0, 6),
               "kind": kind}
        rec.update(fields)
        self.events.append(rec)

    def record(self, name: str, value: float):
        self.series[name].append(float(value))

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name + "_s", time.perf_counter() - t0)

    def summary(self) -> Dict:
        out = {"counters": dict(self.counters), "series": {}}
        for name, vals in self.series.items():
            if vals:
                out["series"][name] = {
                    "n": len(vals),
                    "mean": sum(vals) / len(vals),
                    "min": min(vals), "max": max(vals),
                }
        return out

    def write_jsonl(self, path: str):
        """One JSON object per line: every event, then one summary row."""
        with open(path, "w") as f:
            for rec in self.events:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({"kind": "summary", **self.summary()})
                    + "\n")


class _NullTelemetry(Telemetry):
    """True no-op sink: long tracking runs with no telemetry configured
    must not accumulate an unbounded events list (odometry emits one
    event per frame unconditionally)."""

    def emit(self, kind: str, **fields):
        pass

    def record(self, name: str, value: float):
        pass

    def count(self, name: str, n: int = 1):
        pass


_NULL = _NullTelemetry()


def get(telemetry: Optional[Telemetry]) -> Telemetry:
    """Null-object helper: callers emit unconditionally; the shared no-op
    sink swallows everything when none was configured."""
    return telemetry if telemetry is not None else _NULL


_NO_SPAN = contextlib.nullcontext()
_host_counts: Dict[str, int] = defaultdict(int)
_device_counts: Dict[tuple, torch.Tensor] = {}


def tracing() -> bool:
    """True while a ``torch.profiler`` session records (~0.2 us)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``record_function(name)`` range while tracing, else the shared
    no-op context: off the profiler a span builds nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` (only while tracing)."""
    if torch.autograd._profiler_enabled():
        _host_counts[name] += int(n)


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the 0-d integer tensor ``value`` into the counter ``name`` on
    its device, without a synchronisation (only while tracing)."""
    if torch.autograd._profiler_enabled():
        key = (name, value.device)
        acc = _device_counts.get(key)
        if acc is None:
            _device_counts[key] = value.to(torch.int64, copy=True)
        else:
            acc.add_(value)


def program_counters() -> Dict[str, int]:
    """Every counter by name, host and device parts summed (one read of
    each device's counters: call it after the work)."""
    out = dict(_host_counts)
    by_dev = defaultdict(list)
    for (name, dev), acc in _device_counts.items():
        by_dev[dev].append((name, acc))
    for items in by_dev.values():
        vals = torch.stack([acc for _, acc in items]).tolist()
        for (name, _), v in zip(items, vals):
            out[name] = out.get(name, 0) + int(v)
    return out


def reset_program_counters() -> None:
    _host_counts.clear()
    _device_counts.clear()

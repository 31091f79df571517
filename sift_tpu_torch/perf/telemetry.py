"""Structured telemetry — counters, timers, and per-frame event records.

A copy of the numpy-free module ``sift_tpu/perf/telemetry.py`` (the JAX
package cannot be imported without JAX).  A ``Telemetry`` sink collects
typed events and scalar series, exposes summaries, and serializes to
JSON-lines; ``MonocularOdometry(telemetry=...)`` emits one event per
frame (mode, matches, inliers, landmark/keyframe counts, loop closures,
BA activity), ``tools/odometry.py --telemetry PATH`` writes the stream.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional


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

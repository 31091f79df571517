"""The timed loop every traffic generator shares.

A generator (``generators/<name>.py``, named by a mix's ``generator``)
defines ``Stream``: its inputs, made on the device from the seed, and one
unit of work, which ``issue`` enqueues.  ``run_window`` drives any stream
the same way.  It dispatches units ahead, with at most ``in_flight`` of
them on the device: each unit's indices are copied into a pinned host
buffer and an event is recorded after the copy; a unit is complete when
its event has completed, that is when its indices have reached host
memory.  A rate is taken over the whole window, from its first issue to
the completion of its last unit.

A traced run profiles ``trace_units`` units from ``trace_at`` of the
window on, and again (at most ``trace_attempts`` profiles) while a
profile lacks a kernel that ``trace_kernels`` names.  Every run keeps
``check_units`` units, drawn from the seed, and holds what the timed path
produced for them against the plain reference once the window has closed.

What a stream provides: ``build()``, ``prefill()`` (set-up),
``issue(buf, keep) -> (host seconds of the program call, the kept unit's
meta or None)``, ``release()``, ``check(samples, control=None, cache=None)
-> {number: value}``, ``end_to_end(window) -> {metric: value}``,
``out_shape``, ``units_per_call``, ``match_sets`` (train sets and query
sets a matcher call reads), ``traced`` and ``device``.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Optional

import numpy as np
import torch

from bench_port import trace as tr

KEEP_SALT = 0x5EED


def record(name: str):
    return torch.profiler.record_function(tr.BENCH_PREFIX + name)


@dataclasses.dataclass
class Sample:
    """A kept unit: what the timed path gave it and its indices."""
    meta: dict
    indices: Optional[np.ndarray] = None


class Reservoir:
    """A uniform sample of ``k`` units of the window, drawn from the
    seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed ^ KEEP_SALT), 0
        self.slot = None

    def offer(self) -> bool:
        self.seen += 1
        if self.seen <= self.k:
            self.slot = self.seen - 1
            return True
        j = self.rng.randrange(self.seen)
        self.slot = j if j < self.k else None
        return self.slot is not None


class Completion:
    """A pinned host buffer and the event after the copy into it (on the
    CPU, where copies are synchronous, no event)."""

    def __init__(self, shape, device):
        cuda = torch.device(device).type == "cuda"
        self.buf = torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def record(self):
        if self.event is not None:
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


@dataclasses.dataclass
class Window:
    attempted: int
    completed: int
    seconds: float
    issue_s: list
    traces: list
    traced: Optional[list]      # the stream's record of the last profile
    samples: list


def run_window(stream, p: dict, seconds: float, seed: int, trace: bool,
               units: Optional[int] = None) -> Window:
    """The measured window (see the module's docstring); with ``units``,
    that many units instead of ``seconds`` (the warm-up)."""
    n_if = int(p["in_flight"])
    slots = [Completion(stream.out_shape, stream.device)
             for _ in range(n_if)]
    keep = Reservoir(int(p["check_units"]), seed)
    samples = [None] * keep.k
    pending = collections.deque()
    issue_s, traces = [], []
    prof, prof_end, traced = None, None, None
    u = done = 0

    def complete():
        nonlocal done
        v, sample = pending.popleft()
        with record("wait"):
            slots[v % n_if].wait()
        done += stream.units_per_call
        if sample is not None:
            sample.indices = slots[v % n_if].buf.numpy().copy()

    t0 = time.perf_counter()
    # A profile under way runs to its last unit, past the window's end if
    # need be (a traced run reports no rate).
    while (u < units if units is not None
           else time.perf_counter() - t0 < seconds or prof is not None):
        if trace and prof is None and len(traces) < int(p["trace_attempts"]) \
                and (not traces or not traces[-1].has_kernels(
                    p["trace_kernels"])) \
                and time.perf_counter() - t0 >= float(p["trace_at"]) * seconds:
            prof, prof_end = tr.start(), u + int(p["trace_units"])
            stream.traced = []
        kept = keep.offer()
        s_issue, meta = stream.issue(slots[u % n_if].buf, kept)
        slots[u % n_if].record()
        sample = None
        if kept:
            sample = samples[keep.slot] = Sample(meta)
        pending.append((u, sample))
        if prof is None:
            issue_s.append(s_issue)
        u += 1
        if prof is not None and u == prof_end:
            while pending:
                complete()
            traces.append(tr.stop(prof))
            prof = None
            traced = stream.traced
            stream.traced = None
        while len(pending) >= n_if:
            complete()
    while pending:
        complete()
    seconds_run = time.perf_counter() - t0
    return Window(attempted=u * stream.units_per_call, completed=done,
                  seconds=seconds_run, issue_s=issue_s, traces=traces,
                  traced=traced,
                  samples=[s for s in samples if s is not None])

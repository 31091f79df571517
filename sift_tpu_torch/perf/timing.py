"""Latency of a chained workload on its device.

Counterpart of ``sift_tpu/perf/timing.py``.  ``chained_runner`` keeps the
JAX package's serialising data dependency: iteration i+1 runs on the carry
of iteration i with the step's probe folded in (``y + probe * 1e-30``), so
every stage of every iteration must run.  The clock differs: the JAX tool
takes the slope between two trip counts, because its transport
acknowledged dispatch before execution; that slope can come out near zero
and was then reported as a time.  Here a CUDA tensor is timed by CUDA
events recorded on its device's current stream around ``k`` chained steps,
which measure the device's own span, and a CPU tensor by
``time.perf_counter`` (the tests' branch, chosen by the tensor's device).
A reading that is not positive and finite raises.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Optional

import torch


# measure_ms's arguments by device type, for the tools that time with it:
# on the card 24 chained iterations, median of 3; on the CPU (the tests'
# branch) one run of 2.
ITERATIONS = {"cuda": dict(k=24, repeats=3), "cpu": dict(k=2, repeats=1)}


def chained_runner(step: Callable, k: int) -> Callable:
    """``x -> probe``: runs ``step`` ``k`` times on a carried value, then
    once more for the probe.  ``step(x) -> (y, probe)``: ``y`` has ``x``'s
    shape and dtype, ``probe`` is a scalar tensor that depends on every
    stage of the step.  The fold ``y + probe * 1e-30`` makes each
    iteration depend on the one before; it leaves a float32 carry
    bit-identical wherever ``|y|`` exceeds ``|probe| * 1e-23`` (a zero
    element of the carry takes the tiny fold)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")

    def run(x):
        carry = x
        for _ in range(k):
            y, probe = step(carry)
            carry = y + probe * 1e-30
        return step(carry)[1]

    return run


def _elapsed_ms(run, x) -> float:
    """Milliseconds of one ``run(x)``: CUDA events on the current stream
    of a CUDA tensor's device, the host clock for a CPU tensor."""
    if x.is_cuda:
        with torch.cuda.device(x.device):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run(x)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
    t0 = time.perf_counter()
    run(x)
    return (time.perf_counter() - t0) * 1e3


def measure_ms(step: Callable, x: torch.Tensor, k: int = 24,
               repeats: int = 3,
               on_first_estimate: Optional[Callable] = None) -> float:
    """Median over ``repeats`` of the per-iteration ms of ``k`` chained
    ``step``s on ``x`` (``chained_runner``), after one untimed warm-up run
    (first use: kernel loads, allocator growth).  ``on_first_estimate``,
    if given, receives the first timed run's per-iteration ms as soon as
    it exists.  Raises ``RuntimeError`` on a reading that is not positive
    and finite."""
    run = chained_runner(step, k)
    run(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    per_iter = []
    for i in range(repeats):
        ms = _elapsed_ms(run, x) / k
        if not (math.isfinite(ms) and ms > 0.0):
            raise RuntimeError(f"measure_ms: reading {ms!r} ms per "
                               f"iteration on {x.device} is not positive "
                               "and finite")
        if i == 0 and on_first_estimate is not None:
            on_first_estimate(ms)
        per_iter.append(ms)
    return statistics.median(per_iter)

"""Readings that several per-layer metrics share: a metric's file under
``metrics/`` names one of these as its ``read`` where the same quantity
moves a different end-to-end metric in different cells."""

from bench_port import rooflines as R


def idle_share(ctx):
    """The device's idle share of the profiled span, in percent: 100 times
    one minus the union of its kernel, copy and memset intervals over the
    span from the first to the last device activity launched in it."""
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def match_roofline(ctx):
    """The matcher's share of its roofline, in percent: the least time of
    a call (its Gram products' operations at the int8 tensor-core peak,
    or its train and query sets, masks and indices at 3.35 TB/s) over the
    device time of the kernels launched in the benchmark's ``match``
    range, over the profiled units.  The stream says how many train and
    query sets a call reads (``match_sets``)."""
    t = ctx.trace.kernel_time_s(where="bench.match")
    if not ctx.units or t <= 0:
        return None
    cap = ctx.capacity
    pairs, qsets = ctx.stream.match_sets
    b, ops = R.match_work(pairs, cap, cap, query_sets=qsets)
    calls = ctx.units   # one matcher call per profiled unit
    return 100.0 * R.bound_s(b, ops, R.PEAK_INT8_OPS) * calls / t

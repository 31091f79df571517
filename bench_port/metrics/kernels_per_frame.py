"""Device kernels a frame's detector call launches: the profiler's kernels
whose launch lies in the benchmark's ``detect`` range, over the profiled
frames."""


def read(ctx):
    if not ctx.units:
        return None
    n = ctx.trace.kernel_count(where="bench.detect")
    return n / ctx.units if n else None

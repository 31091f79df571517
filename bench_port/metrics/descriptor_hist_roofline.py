"""K3's share of its roofline, in percent: the least time of the profiled
frames' descriptor histograms (their live keypoints' windows, parameter
rows and output rows at 3.35 TB/s, or their operations at 67 TFLOP/s,
the larger) over the device time of the ``descriptor_hist`` kernel in
those frames."""

from bench_port import rooflines as R


def read(ctx):
    t = ctx.trace.kernel_time_s("descriptor_hist", "bench.detect")
    if not ctx.units or t <= 0:
        return None
    bound = sum(R.bound_s(b, ops, R.PEAK_F32_FLOPS)
                for b, ops in ctx.descriptor_work())
    return 100.0 * bound / t

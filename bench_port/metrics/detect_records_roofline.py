"""K1's share of its roofline, in percent: the least time of one frame's
record field (the pyramid's Gaussian layers read once, the three record
planes written once, at 3.35 TB/s; or its operations at 67 TFLOP/s) over
the device time of the ``detect_records`` kernel a profiled frame."""

from bench_port import rooflines as R


def read(ctx):
    t = ctx.trace.kernel_time_s("detect_records", "bench.detect")
    if not ctx.units or t <= 0:
        return None
    shapes = ctx.octave_shapes()
    layers = int(ctx.config["sift"]["num_octave_layers"]) + 3
    bound = R.bound_s(R.detect_records_bytes(shapes, layers),
                      R.detect_records_ops(shapes, layers), R.PEAK_F32_FLOPS)
    return 100.0 * bound * ctx.units / t

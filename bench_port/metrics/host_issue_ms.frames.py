"""Host milliseconds to enqueue one frame: the clock around
``SiftDetector.detect_and_compute`` with no synchronisation, averaged
over the window's frames outside the profiled span."""


def read(ctx):
    ms = ctx.host_issue_ms()
    return sum(ms) / len(ms) if ms else None

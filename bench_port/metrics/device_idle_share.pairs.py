"""The device's idle share of the profiled span, in percent
(``readers.idle_share``)."""

from bench_port.readers import idle_share as read  # noqa: F401

"""The matcher's share of its roofline, in percent
(``readers.match_roofline``)."""

from bench_port.readers import match_roofline as read  # noqa: F401

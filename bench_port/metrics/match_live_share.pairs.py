"""The share of the matcher's distance entries that pair a live query row
with a live train row, in percent: the program's counters over the
profiled calls (``spans.live_share``)."""

from bench_port.spans import live_share as read  # noqa: F401

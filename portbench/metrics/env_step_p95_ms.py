"""The 95th percentile, over every env step of the window, of the time from
the call to the end of that step's host fetch."""

from ..stats import percentile


def read(rec, name):
    if not rec.latencies_s:
        return None
    return percentile(rec.latencies_s, 95) * 1e3

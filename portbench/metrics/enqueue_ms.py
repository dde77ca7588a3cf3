"""Median host time for the env layer's entry point to return, before the
step's fetch (the host's share of a step)."""

from ..stats import median


def read(rec, name):
    if not rec.enqueue_s:
        return None
    return median(rec.enqueue_s) * 1e3

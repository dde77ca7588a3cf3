"""Boards x env steps completed in the window over the window."""

from ..stats import rate


def read(rec, name):
    return rate(rec.work, rec.window_s)

"""Board-steps of every chunk completed in the window over the window,
from its first call to the host fetch that ends it."""

from ..stats import rate


def read(rec, name):
    return rate(rec.work, rec.window_s)

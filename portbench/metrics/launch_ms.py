"""Median, over the program's ``env.step`` spans in the window, of the
summed ``chunk.launch`` and ``merge.launch`` spans: the host time of the
two ctypes launcher calls and their error checks."""

from ..program_trace import duration_ms, roots
from ..stats import median
from .marshal_ms import LAUNCHES


def read(rec, name):
    steps = roots(rec, "env.step")
    if not steps:
        return None
    return median([sum(duration_ms(c) for c in kids if c.name in LAUNCHES)
                   for _, kids in steps])

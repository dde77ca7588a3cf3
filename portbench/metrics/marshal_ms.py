"""Median, over the program's ``env.step`` spans in the window (the
mixed-control env step's entry point), of the span's time less its
``chunk.launch`` and ``merge.launch`` spans: the host time of the env and
chunk wrappers around their two launcher calls (argument checks,
conversions, views, output casts and recount)."""

from ..program_trace import duration_ms, roots
from ..stats import median

LAUNCHES = ("chunk.launch", "merge.launch")


def read(rec, name):
    steps = roots(rec, "env.step")
    if not steps:
        return None
    return median([duration_ms(r) - sum(duration_ms(c) for c in kids
                                        if c.name in LAUNCHES)
                   for r, kids in steps])

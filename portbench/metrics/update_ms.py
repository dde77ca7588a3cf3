"""Median, over the window's PPO iterations, of the time from the start of
the program's ``ppo.update`` span to the end of the host fetch of the
iteration's metrics that follows it (the benchmark's ``train.fetch``
span).  The update's device work is asynchronous: its span ends once the
last optimizer step is enqueued, and only the fetch waits for the device
to finish it, so the update's time runs to the fetch's end."""

import bisect

from ..program_trace import roots
from ..stats import median

FETCH = "train.fetch"


def read(rec, name):
    steps = roots(rec, "ppo.step")
    ends = sorted((e - rec.wall_offset) * 1e9 for n, _, e in rec.spans
                  if n == FETCH)
    times = []
    for root, kids in steps:
        starts = [c.start_ns for c in kids if c.name == "ppo.update"]
        i = bisect.bisect_left(ends, root.end_ns)
        if starts and i < len(ends):
            times.append((ends[i] - starts[0]) * 1e-6)
    return median(times) if times else None

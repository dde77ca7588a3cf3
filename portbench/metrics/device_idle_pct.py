"""100 x (1 - the union of device activity over the traced window's wall
time), from the run's one profiler session; every split
(``device_idle_pct.<part>``) reads it alike."""

from ..stats import idle_pct


def read(rec, name):
    if not rec.ops:
        return None
    return idle_pct([(s, e) for _, s, e in rec.ops], rec.window_s)

"""The chunk kernel's share of its roofline: the copied bound
(``peaks.bound_s``: state bytes in and out over the memory rate, or one
32-bit instruction per state value per board-step over the issue rate read
from the card) over the kernel's mean device time in the trace."""

from ..peaks import bound_s


def read(rec, name):
    if not rec.ops or not rec.roofline or rec.rates is None:
        return None
    kernel = rec.roofline["kernel"]
    times = [e - s for n, s, e in rec.ops if n.startswith(kernel)]
    if not times:
        return None
    least = bound_s(rec.roofline["board_steps"], rec.roofline["bytes"],
                    rec.rates)
    return 100.0 * least / (sum(times) / len(times))

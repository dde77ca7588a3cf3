"""The program's own spans, counters and sampled phase clocks
(``pomcpp_tpu_torch.trace``) over a run's window, for the per-layer readers
that read them.

Importing this module turns the program's tracing on.  ``run.py`` imports a
cell's per-layer readers only in a ``--trace 1`` run, before set-up, so
the end-to-end runs keep it off.  A program without that module (an older
commit) gives no records, and every reader then returns None.

A root span counts as the window's when it lies inside ``[rec.first_call,
rec.first_call + rec.window_s]`` (both on ``time.perf_counter()``'s
clock, which the program's ``perf_counter_ns`` shares).

The first read of a traced record appends program spans to ``rec.spans``
on the wall clock (``rec.wall_offset``), so that ``breakdown.idle_gaps``,
which names each idle gap by the innermost span around its midpoint,
names the program's layers inside the benchmark's ``env.call`` /
``chunk.call``.  That labelling checks every span for every gap, so what
is appended is bounded: only the innermost spans (they tile their
parents), only those that hold a gap's midpoint (no other can name one),
and, where that is more than ``LABEL_CHECKS`` span-gap checks would
allow, the spans of every k-th root alone (a host-bound env window of 10 s
has about 11,000 steps and 260,000 gaps).  Then the breakdown names the
program's spans in one root in k, and leaves the rest under the
benchmark's own.  The spans are then laid out afresh, in time order: while
tracing, the program allocates between the benchmark's span objects, and
the labelling's pass over the scattered objects ran 30-50% slower a check
on the card's host.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import operator

from .stats import idle_gaps

# The most span-gap checks the appended spans may add to the gap labelling
# (about 30 s on the card's host, which took 100 s for 1e9).
LABEL_CHECKS = 3 * 10 ** 8

try:
    from pomcpp_tpu_torch import trace as _trace
except ImportError:
    _trace = None
else:
    _trace.enable()


@dataclasses.dataclass
class Window:
    """``roots``: ``(root span, [its descendants])`` of the window, in
    order; ``rows``: the phase totals (dicts) of the sampled calls whose
    ``chunk`` span lies in the window."""

    roots: list
    rows: list


def window(rec, records, rows) -> Window:
    """The window's roots and sampled rows from the program's span records
    (oldest first, as ``trace.records()``) and ``PhaseRow`` s."""
    lo = rec.first_call * 1e9
    hi = (rec.first_call + rec.window_s) * 1e9
    roots, inside, pending = [], {}, []
    for r in records:       # a span is recorded when it ends: children first
        if r.parent_id:
            pending.append(r)
            continue
        if lo <= r.start_ns and r.end_ns <= hi:
            roots.append((r, pending))
            inside[r.span_id] = r
            inside.update((c.span_id, c) for c in pending)
        pending = []
    return Window(roots, [row.totals for row in rows
                          if inside.get(row.span_id, None) is not None
                          and inside[row.span_id].name == "chunk"])


_last: tuple = (None, None)


def of(rec) -> Window | None:
    """The program's records of ``rec``'s window, or None without any; the
    first read appends the innermost spans to ``rec.spans``."""
    global _last
    if _last[0] is rec:
        return _last[1]
    win = None
    if _trace is not None:
        win = window(rec, _trace.records(), _trace.phase_rows())
        spans = sorted(rec.spans + gap_spans(rec, win),
                       key=operator.itemgetter(1))
        rec.spans[:] = [(n, a + 0.0, b + 0.0) for n, a, b in spans]  # new floats
        if not win.roots:
            win = None
    _last = (rec, win)
    return win


def gap_spans(rec, win: Window) -> list:
    """The program spans to lay beside the benchmark's, as ``(name, start,
    end)`` on the wall clock (see the module's note); none without a device
    trace."""
    if not rec.ops or not win.roots:
        return []
    start = rec.first_call + rec.wall_offset
    mids = sorted((s + e) / 2 for s, e in idle_gaps(
        [(s, e) for _, s, e in rec.ops], start, start + rec.window_s))
    parents = {c.parent_id for _, kids in win.roots for c in kids}
    by_root = []
    for root, kids in win.roots:
        spans = []
        for s in kids + [root]:
            if s.span_id in parents:
                continue
            a = s.start_ns * 1e-9 + rec.wall_offset
            b = s.end_ns * 1e-9 + rec.wall_offset
            if bisect.bisect_left(mids, a) < bisect.bisect_right(mids, b):
                spans.append((s.name, a, b))
        by_root.append(spans)
    total = sum(map(len, by_root))
    stride = max(1, math.ceil(total * len(mids) / LABEL_CHECKS))
    return [s for spans in by_root[::stride] for s in spans]


def roots(rec, name: str) -> list:
    """``(root, descendants)`` of the window whose root is named ``name``."""
    win = of(rec)
    return [] if win is None else [(r, k) for r, k in win.roots if r.name == name]


def rows(rec) -> list:
    """The phase totals of the window's sampled chunk calls."""
    win = of(rec)
    return [] if win is None else win.rows


def duration_ms(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-6

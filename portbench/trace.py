"""One ``torch.profiler`` session over a run's window, reduced to the
device's operations.

Only CUDA activity is recorded (no host operators), so the session adds
little to the host's time per call.  The events are read from the
session's results in memory; their timestamps are nanoseconds on the
host's wall clock, which is how the host's spans (``time.time()``
seconds) are laid beside them.
"""

from __future__ import annotations

import re

from torch.autograd import DeviceType


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and namespace:
    ``void rollout_chunk_kernel<true>(StateView, ...)`` ->
    ``rollout_chunk_kernel<true>``; template arguments longer than 16
    characters become ``...``."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    base = "".join(out).strip()
    head, sep, args = base.partition("<")
    if len(args) > 16:      # a library kernel's functor types
        args = "...>"
    return head.split("::")[-1] + sep + args


def device_ops(events):
    """Device operations ``(name, start_s, end_s)`` of the profiler's
    events, on the wall clock (``time.time()`` seconds)."""
    ops = []
    for ev in events:
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns() * 1e-9
        ops.append((short_name(ev.name()) or "unnamed", start,
                    start + ev.duration_ns() * 1e-9))
    return ops


class DeviceTrace:
    """``with DeviceTrace() as tr: ...`` records the device's operations
    into ``tr.ops``."""

    def __init__(self):
        self.ops = []
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = device_ops(self._prof.profiler.kineto_results.events())
        return False

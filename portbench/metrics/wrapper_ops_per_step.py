"""The program's ``wrapper_ops`` counter (device operations its chunk and
env wrappers enqueue with their own PyTorch calls) over the window's
``env.step`` spans, per span."""

from ..program_trace import roots


def read(rec, name):
    steps = roots(rec, "env.step")
    if not steps:
        return None
    return sum(r.counts.get("wrapper_ops", 0) for r, _ in steps) / len(steps)

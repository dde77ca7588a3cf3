"""The SimpleAgent's BFS rounds per board-step, summed over the window's
sampled chunk calls (``n_bfs_rounds`` over ``n_steps``)."""

from ..program_trace import rows


def read(rec, name):
    got = rows(rec)
    steps = sum(r["n_steps"] for r in got)
    if not steps:
        return None
    return sum(r["n_bfs_rounds"] for r in got) / steps

"""The share of board-steps whose SimpleAgent act ran a BFS round, summed
over the window's sampled chunk calls (``n_bfs_acts`` over ``n_steps``);
nothing where the program's phase rows do not count such acts."""

from ..program_trace import rows


def read(rec, name):
    got = rows(rec)
    steps = sum(r["n_steps"] for r in got)
    if not steps or any("n_bfs_acts" not in r for r in got):
        return None
    return sum(r["n_bfs_acts"] for r in got) / steps

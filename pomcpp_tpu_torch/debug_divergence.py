"""Replay one census batch and print field-level diffs for divergent steps.

    python -m pomcpp_tpu_torch.debug_divergence [--batch-index 1]
        [--batch 500] [--steps 800] [--seed 0] [--boards 3,17]
        [--policy random|simple] [--device cpu]

Counterpart of ``scripts/debug_divergence.py``, the debug aid for the
census's findings (``divergence_census``).  It plays the census's batch
``--batch-index`` (the reference's boards for seeds ``seed + bi * batch +
g``, kick on odd ``g``) with the exact engine and the plane engine in
lockstep through ``divergence_census.census_step``.  The plane state is
re-synced to the exact one after every step, so each step starts equal;
for every live board whose step diverges it prints ``t= board= mv=
classes=`` (``testing.divergence.divergence_classes``) and, for each
differing ``CellState`` field, its first 8 differing cells (``exact=`` /
``cell=``).  Moves are the census's own draws, or ``debug_report(...,
moves=)`` (``[steps, batch, 4]``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .agents.simple import simple_agent_init
from .agents.simple_cellular import simple_agent_cell_joint
from .core.state import I32, state_of
from .device import resolve_device
from .divergence_census import CMP_FIELDS, _take, census_step, start_states
from .engine.cellular import board_of, from_state
from .testing.divergence import divergence_classes


def _select(eq, a, b):
    """Board-wise ``a`` where ``eq`` else ``b`` over a ``CellState``."""
    return type(a)(*(torch.where(eq.reshape((-1,) + (1,) * (x.dim() - 1)),
                                 x, y) for x, y in zip(a, b)))


def _cpu(cs):
    """A ``CellState``'s tensors on the host."""
    return type(cs)(*(t.cpu() for t in cs))


def _field_lines(post, cell) -> list[str]:
    """One line per differing field of two one-board ``CellState``s."""
    lines = []
    for f in CMP_FIELDS:
        av = np.atleast_1d(getattr(post, f).numpy())
        bv = np.atleast_1d(getattr(cell, f).numpy())
        if not np.array_equal(av, bv):
            w = np.nonzero(av != bv)[0][:8]
            lines.append(f"  {f}@{w.tolist()}: exact={av[w]} cell={bv[w]}")
    return lines


def debug_report(batch_index: int = 1, batch: int = 500, steps: int = 800,
                 seed: int = 0, boards=(), policy: str = "random",
                 device=None, moves=None, log=print) -> list[str]:
    """Run the batch on ``device`` (None: the card); returns the report's
    lines, each also passed to ``log``.  ``boards`` limits the report to
    those board indices."""
    device = resolve_device(device)
    want = set(boards)
    game0 = seed + batch_index * batch
    s, c = start_states(range(game0, game0 + batch), device)
    gen = torch.Generator(device=device).manual_seed(seed * 7919 + batch_index)
    ps = simple_agent_init((batch, 4), device) if policy == "simple" else None
    lines = []
    for t in range(steps):
        if moves is not None:
            mv = torch.as_tensor(moves[t]).to(device=device, dtype=I32)
        elif policy == "simple":
            rands = torch.randint(0, 5, (batch, 4), generator=gen,
                                  device=device, dtype=I32)
            mv, _, ps = simple_agent_cell_joint(c, ps, rands)
            mv = torch.where(c.agent_dead, 0, mv).to(I32)
        else:
            mv = torch.randint(0, 6, (batch, 4), generator=gen,
                               device=device, dtype=I32)
        live = s.alive_count > 1
        s_pre = s
        s, c2, eq = census_step(s, c, mv)
        c = _select(eq, c2, from_state(s))
        neq, live = torch.stack([~eq & live, live]).cpu()
        idx = [i for i in neq.nonzero()[:, 0].tolist()
               if not want or i in want]
        if idx:
            rows = torch.as_tensor(idx, device=device)
            pre_e = _take(s_pre, rows)
            pre_c, post_c = from_state(pre_e), from_state(_take(s, rows))
            cell = _take(c2, rows)
            mv_h = mv.index_select(0, rows).cpu()
            for k, i in enumerate(idx):
                one_post = board_of(post_c, k)
                cl = divergence_classes(board_of(pre_c, k), mv_h[k], one_post,
                                        pre_exact=state_of(pre_e, k))
                out = [f"t={t} board={i} mv={mv_h[k].tolist()} classes={cl}"]
                out += _field_lines(_cpu(one_post), _cpu(board_of(cell, k)))
                for line in out:
                    log(line)
                lines += out
        if not bool(live.any()):
            break
    return lines


def main(argv=None, moves=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch-index", type=int, default=1)
    p.add_argument("--batch", type=int, default=500)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--boards", type=str, default="",
                   help="comma-separated board indices to report "
                        "(default all)")
    p.add_argument("--policy", choices=["random", "simple"], default="random")
    p.add_argument("--device", default=None,
                   help="cpu for the plain run on the CPU (default: the card)")
    args = p.parse_args(argv)
    want = [int(b) for b in args.boards.split(",") if b != ""]
    debug_report(args.batch_index, args.batch, args.steps, args.seed, want,
                 args.policy, args.device, moves,
                 log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

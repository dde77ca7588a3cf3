"""Measure how often the cellular plane engine diverges from the exact
conformance engine in real play.

    python -m pomcpp_tpu_torch.divergence_census --games 10000 --steps 800 \
        [--batch 10000] [--seed 0] [--policy random|simple] [--device cpu]

Counterpart of ``scripts/divergence_census.py``, as a batched program on the
card.  Both engines step in lockstep over batches of full-length games (the
exact engine is the oracle: bit-parity with the compiled C++ reference).
After every step all ``CellState`` fields but ``timestep`` are compared per
board; a board's FIRST divergent step is classified against the four
documented divergence classes (``testing.divergence``) and the board is
then frozen out of the census.  First-divergence semantics matter: a
class-1 event (the reference stacks two bombs on one cell) leaves the exact
state outside the plane encoding, so every later step on that board would
re-diverge as a cascade of the first event.

Games start from the reference's own boards (``init_states_np``, seeds
``seed + game``), half of them with kick.  Moves are the port's own draws:
uniform in [0, 6) from a ``torch.Generator`` on the device (random), or the
SimpleAgent of ``agents.simple_cellular`` acting on the synced plane state
with rands in [0, 5) (simple; dead agents idle).  ``run_census(...,
moves=)`` takes the moves instead (``[steps, games, 4]``; the tests).

A board that is frozen (diverged) or no longer live (fewer than two agents
alive; games do not reset) never counts again, so the batch is compacted to
the boards still counted after a step that drops some; the result is the
same as stepping every board to the end, and the run ends when no board is
left.  One host read a step fetches the per-board verdicts.

Prints per-batch progress and, last, one JSON object: per-class counts and
first divergences per synced live board-step (ppm).  An UNCLASSIFIED first
divergence is a bug: the exit code is then 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .agents.simple import simple_agent_init
from .agents.simple_cellular import simple_agent_cell_joint
from .core.board_gen import init_states_np
from .core.state import I32, map_state, state_of
from .device import resolve_device
from .engine.cellular import CellState, board_of, cellular_step, from_state
from .engine.step import step
from .testing.divergence import divergence_classes

CLASSES = ("1:stacked-plant", "2:stale-plant-direction",
           "3:multi-bomb-chain", "4:multi-bomb-pileup")
CMP_FIELDS = [f for f in CellState._fields if f != "timestep"]


def start_states(seeds, device):
    """The census's boards: the reference's board of each seed, kick on for
    odd game indices; returns the exact states and their planes."""
    s = init_states_np(seeds, device=device)
    b = len(seeds)
    kick = (torch.arange(b, device=s.board.device) % 2 == 1)[:, None]
    s = s._replace(agent_can_kick=kick.expand(b, 4).clone())
    return s, from_state(s)


def _equal_boards(a: CellState, b: CellState) -> torch.Tensor:
    """bool[B]: every compared field equal on the board."""
    eq = torch.ones(a.board.shape[0], dtype=torch.bool, device=a.board.device)
    for f in CMP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        d = (x != y).reshape(x.shape[0], -1).any(1)
        eq = eq & ~d
    return eq


def census_step(s, c, mv):
    """One lockstep step of both engines on the same moves: (exact state,
    plane state, bool[B] boards equal)."""
    s2 = step(s, mv)
    c2 = cellular_step(c, mv)
    return s2, c2, _equal_boards(from_state(s2), c2)


def _take(tree, idx):
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, idx)
    if hasattr(tree, "bombs"):
        return map_state(lambda t: t.index_select(0, idx), tree)
    return type(tree)(*(t.index_select(0, idx) for t in tree))


def _classify(s_pre, mv, s_post, boards, games, counts, unclassified, where):
    """Classify the first divergences of ``boards`` (rows of the compacted
    batch; ``games`` their game indices, for the report)."""
    multi = 0
    idx = torch.as_tensor(boards, device=s_pre.board.device)
    pre_e, post_e = _take(s_pre, idx), _take(s_post, idx)
    pre_c, post_c = from_state(pre_e), from_state(post_e)
    mv = mv.index_select(0, idx).cpu()
    for k in range(len(boards)):
        cl = divergence_classes(board_of(pre_c, k), mv[k], board_of(post_c, k),
                                pre_exact=state_of(pre_e, k))
        if not cl:
            unclassified.append(where + (games[k],))
            continue
        multi += len(cl) > 1
        for name in cl:
            counts[name] += 1
    return multi


def run_census(games: int, steps: int, batch: int = 10000, seed: int = 0,
               policy: str = "random", device=None, moves=None,
               log=print) -> dict:
    """The census; returns its JSON object.  ``moves`` (i32[steps, games,
    4]) replaces the port's move draws (random policy)."""
    device = resolve_device(device)
    counts = {name: 0 for name in CLASSES}
    multi = 0
    unclassified = []
    live_steps = 0
    first_div = 0
    steps_run = board_steps = 0
    t_start = time.perf_counter()
    n_batches = (games + batch - 1) // batch
    for bi in range(n_batches):
        b = min(batch, games - bi * batch)
        game0 = bi * batch
        s, c = start_states(range(seed + game0, seed + game0 + b), device)
        ids = torch.arange(b, device=device)   # game index within the batch
        gen = torch.Generator(device=device).manual_seed(seed * 7919 + bi)
        ps = simple_agent_init((b, 4), device) if policy == "simple" else None
        for t in range(steps):
            if moves is not None:
                mv = torch.as_tensor(moves[t]).to(device=device, dtype=I32)
                mv = mv[game0:game0 + b].index_select(0, ids)
            elif policy == "simple":
                rands = torch.randint(0, 5, (ids.numel(), 4), generator=gen,
                                      device=device, dtype=I32)
                mv, _, ps = simple_agent_cell_joint(c, ps, rands)
                mv = torch.where(c.agent_dead, 0, mv).to(I32)
            else:
                mv = torch.randint(0, 6, (ids.numel(), 4), generator=gen,
                                   device=device, dtype=I32)
            live = s.alive_count > 1
            s_pre = s
            s, c, eq = census_step(s, c, mv)
            steps_run += 1
            board_steps += ids.numel()
            # Every board still in the batch is synced: one host read.
            neq, live = torch.stack([~eq & live, live]).cpu()
            live_steps += int(live.sum())
            boards = neq.nonzero()[:, 0].tolist()
            if boards:
                first_div += len(boards)
                multi += _classify(s_pre, mv, s, boards,
                                   ids[boards].tolist(), counts,
                                   unclassified, (bi, t))
            keep = live & ~neq
            if not keep.all():
                if not keep.any():
                    break
                idx = keep.nonzero()[:, 0].to(device)
                s, c, ids = _take(s, idx), _take(c, idx), ids[idx]
                if ps is not None:
                    ps = _take(ps, idx)
        ppm = 1e6 * first_div / max(live_steps, 1)
        log(f"batch {bi + 1}/{n_batches}: games={game0 + b} "
            f"live_steps={live_steps} div={first_div} ({ppm:.1f} ppm)  "
            f"[{time.perf_counter() - t_start:.0f}s]")
    return {
        "policy": policy,
        "games": games,
        "steps_cap": steps,
        "synced_live_board_steps": live_steps,
        "first_divergences": first_div,
        "divergence_ppm": round(1e6 * first_div / max(live_steps, 1), 2),
        "class_counts": counts,
        "multi_class_steps": multi,
        "unclassified": len(unclassified),
        "unclassified_at": unclassified[:10],
        "lockstep_steps": steps_run,
        "board_steps_run": board_steps,
        "seconds": time.perf_counter() - t_start,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--games", type=int, default=10000)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy", choices=["random", "simple"], default="random",
                   help="simple = SimpleAgent self-play (the realistic-"
                        "policy census; random is the worst case)")
    p.add_argument("--device", default=None,
                   help="cpu for the plain run on the CPU (default: the card)")
    args = p.parse_args(argv)
    out = run_census(args.games, args.steps, args.batch, args.seed,
                     args.policy, args.device,
                     log=lambda m: print(m, flush=True))
    where = out.pop("unclassified_at")
    for extra in ("lockstep_steps", "board_steps_run", "seconds"):
        out.pop(extra)
    print(json.dumps(out))
    if out["unclassified"]:
        print(f"UNCLASSIFIED divergences at (batch,t,board): {where}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

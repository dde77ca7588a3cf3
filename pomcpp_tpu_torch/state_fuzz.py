"""Randomized-state exhaustive conformance fuzzer.

    python -m pomcpp_tpu_torch.state_fuzz --states 20 [--steps-range 20,90]
        [--n-moves 5] [--seed 0] [--device cpu]

Counterpart of ``scripts/state_fuzz.py``, with the sweep on the card.  It
SNAPSHOTS random exact-engine trajectories mid-game (flames, revealed
powerups, kicked bombs in flight, heterogeneous agent stats), then sweeps
ALL (n_moves^3)^2 two-step joint moves of the first three live agents as
ONE batched call of two exact steps over n_moves^6 boards (15,625 at
``n_moves=5``), and diffs every resulting state's oracle dump bit for bit:
against the compiled reference (``testing.oracle.enum3_trio``, after the
injected state echoes back unchanged) when ``ensure_oracle`` finds it, and
against ``fuzz_one(..., reference=)`` -- the same sweep on another device,
or another implementation -- when one is given.

The snapshot's moves come from ``np.random.RandomState(seed ^ 0x5EED)``, as
in the JAX script, so its snapshots are the JAX package's own states; the
command line's seeds and snapshot steps are the script's, the candidate
games stepped ``SEARCH_BATCH`` at a time (``find_snapshots``).  The command line asserts
that the oracle is buildable, as the JAX script does; exit 0 = every
sequence of every state matches, 1 = a mismatch.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .core.board_gen import init_states_np
from .core.state import I32, map_state, state_of
from .device import resolve_device
from .engine.step import step
from .testing import oracle as orc

# Candidate games ``find_snapshots`` steps as one batch.  The states it
# yields do not depend on it; about 1 game in 20 keeps three agents alive to
# its snapshot, so a batch finds several.
SEARCH_BATCH = 256


def snapshots(seeds, snap_steps, device=None) -> list:
    """The fuzzer's states for ``seeds``, each after its ``snap_steps``
    random steps, stepped as ONE batch on ``device`` (None: the card).
    Returns ``(seed, snap_step, state)`` for the seeds with at least three
    agents alive at their snapshot, in order; each state is a batch of
    one.  Kick is on for every agent on odd seeds.  A board's moves are
    ``RandomState(seed ^ 0x5EED).randint(0, 6, 4)`` a step, the JAX
    script's; no agent revives, so three alive at the snapshot means three
    alive at every step before it."""
    seeds, snap_steps = list(seeds), list(snap_steps)
    s = init_states_np(seeds, device=device)
    odd = torch.tensor([sd % 2 == 1 for sd in seeds], device=s.board.device)
    s = s._replace(agent_can_kick=s.agent_can_kick | odd[:, None])
    t_max = max(snap_steps)
    moves = torch.from_numpy(np.stack([
        np.random.RandomState(sd ^ 0x5EED).randint(0, 6, (t_max, 4))
        for sd in seeds], 1).astype(np.int32))
    out = {}
    for t in range(t_max + 1):
        if t:
            s = step(s, moves[t - 1])
        for k in (k for k, n in enumerate(snap_steps) if n == t):
            out[k] = map_state(lambda x: x[k:k + 1].clone(), s)
    return [(seeds[k], snap_steps[k], out[k]) for k in range(len(seeds))
            if int(out[k].alive_count[0]) >= 3]


def find_snapshots(states: int, lo: int, hi: int, seed: int = 0,
                   device=None):
    """The command line's states in its order: attempt ``i`` is seed
    ``seed * 100000 + i`` with the i-th draw of ``RandomState(seed)
    .randint(lo, hi)`` as its snapshot step, and a seed whose game is too
    dead at its snapshot is passed over.  Yields ``(seed, snap, state)``;
    the attempts are searched ``SEARCH_BATCH`` at a time."""
    rng = np.random.RandomState(seed)
    attempt = found = 0
    while found < states:
        seeds = [seed * 100000 + attempt + j for j in range(SEARCH_BATCH)]
        snaps = [int(rng.randint(lo, hi)) for _ in range(SEARCH_BATCH)]
        attempt += SEARCH_BATCH
        for hit in snapshots(seeds, snaps, device)[:states - found]:
            found += 1
            yield hit


def live_agents(s) -> list[int]:
    """The live agents of a one-board batch."""
    return [i for i, d in enumerate(s.agent_dead[0].tolist()) if not d]


def sweep_moves(agents, n_moves: int) -> np.ndarray:
    """i32[2, n^6, 4]: the oracle's ``loadenum3`` order for three agents
    (step-1 moves ``(c1 % n, c1 // n % n, c1 // n^2)`` with ``c1 = code %
    n^3``, step-2 likewise from ``code // n^3``; the fourth agent IDLE)."""
    a, b, c = agents
    n3 = n_moves ** 3
    code = np.arange(n3 * n3)
    mv = np.zeros((2, n3 * n3, 4), np.int32)
    for t, ct in enumerate((code % n3, code // n3)):
        mv[t, :, a] = ct % n_moves
        mv[t, :, b] = ct // n_moves % n_moves
        mv[t, :, c] = ct // n_moves ** 2
    return mv


def repeat(s, n: int):
    """The batch ``s`` (of one board, or already of ``n``) as ``n``
    boards."""
    return map_state(lambda t: t.expand((n,) + t.shape[1:]).contiguous(), s)


def two_steps(s, moves):
    """ONE batched call of two exact steps of every sequence of ``moves``
    ([2, N, 4]) from ``s`` (a batch of one, copied to the N sequences, or
    of N), on ``s``'s device."""
    mv = torch.as_tensor(np.asarray(moves)).to(device=s.board.device,
                                               dtype=I32)
    return step(step(repeat(s, mv.shape[1]), mv[0]), mv[1])


def fuzz_state(s, n_moves: int, reference=None, verbose=print,
               stats=None, label: str = ""):
    """Sweep the snapshot ``s`` (a batch of one with three agents alive or
    more) and hold it.  Returns the number of mismatching sequences.  The
    sweep is held against the oracle when ``ensure_oracle()`` finds it and
    against ``reference(s, moves) -> [n^6 dumps]`` when given (``moves``
    the sweep's i32[2, n^6, 4]); with neither it raises.  ``stats`` (a
    dict) receives the sweep's host-clocked ms (synchronised), its
    sequence count and what held it."""
    agents = live_agents(s)[:3]
    held = {}
    if orc.ensure_oracle() is not None:
        base = orc.state_to_dump(state_of(s, 0))
        echo, held["oracle"] = orc.enum3_trio(base, *agents, n_moves=n_moves)
        d = orc.diff_dumps(echo, base)
        assert not d, f"{label}: state injection diverged: {d[:5]}"
    mv = sweep_moves(agents, n_moves)
    if reference is not None:
        held["reference"] = reference(s, mv)
    if not held:
        raise RuntimeError("state_fuzz: no oracle and no reference to hold "
                           "the sweep against")

    device = s.board.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = two_steps(s, mv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sweep_ms = (time.perf_counter() - t0) * 1e3
    mine = orc.states_to_dumps(out)

    bad = 0
    for k, dump in enumerate(mine):
        diff = [d for ref in held.values()
                for d in orc.diff_dumps(ref[k], dump)]
        if diff:
            bad += 1
            if bad <= 3:
                verbose(f"  {label} seq {k} (mv1={mv[0, k].tolist()} "
                        f"mv2={mv[1, k].tolist()}): {diff[:3]}")
    if stats is not None:
        stats.update(sweep_ms=sweep_ms, sequences=len(mine),
                     held_by=sorted(held))
    return bad


def fuzz_one(seed: int, snap_step: int, n_moves: int, device=None,
             reference=None, verbose=print, stats=None):
    """Snapshot a random trajectory at ``snap_step`` and sweep it
    (``fuzz_state``).  Returns the number of mismatching sequences (0 =
    pass), or None when fewer than 3 agents live at the snapshot."""
    found = snapshots([seed], [snap_step], resolve_device(device))
    if not found:
        return None
    return fuzz_state(found[0][2], n_moves, reference, verbose, stats,
                      f"seed {seed} snap {snap_step}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--states", type=int, default=20)
    p.add_argument("--steps-range", type=str, default="20,90")
    p.add_argument("--n-moves", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cpu for the plain run on the CPU (default: the card)")
    args = p.parse_args(argv)
    lo, hi = (int(x) for x in args.steps_range.split(","))
    device = resolve_device(args.device)
    assert orc.ensure_oracle() is not None, "reference oracle not buildable"

    done = total_bad = 0
    for seed, snap, s in find_snapshots(args.states, lo, hi, args.seed,
                                        device):
        bad = fuzz_state(s, args.n_moves, label=f"seed {seed} snap {snap}")
        done += 1
        total_bad += bad
        print(f"state {done}/{args.states} (seed {seed}, snap {snap}): "
              f"{'OK' if bad == 0 else f'{bad} MISMATCHES'}", flush=True)
    print(f"fuzz complete: {done} states x {args.n_moves ** 6} sequences, "
          f"{total_bad} mismatches")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())

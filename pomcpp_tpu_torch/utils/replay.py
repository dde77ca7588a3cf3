"""Game recording and replay.

Counterpart of ``pomcpp_tpu.utils.replay``, in its npz layout: a replay is
one file holding ``moves`` (i32[T, 4]) and ``leaf_0`` ... ``leaf_{n-1}``,
the leaves of one board's state stacked over T + 1 steps (the initial state
first), in the order the JAX package flattens the same NamedTuple (fields
in order, nested tuples depth first).  A replay of a ``CellState`` or of a
queue-encoded ``State`` written by either package therefore loads in the
other.

The port's engine steps batches, so ``record_game`` steps a batch and
records one board of it (``board=``); what it stores has no batch axis, as
the JAX package's single-game replays have none.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _leaves(tree) -> list:
    """The tensors of a (nested) NamedTuple in the JAX package's order."""
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure filled from the iterator ``leaves``."""
    if isinstance(template, tuple):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    return next(leaves)


def record_game(game0, step_fn, moves_fn, n_steps: int, board: int = 0):
    """Roll a batch of games and record board ``board``.

    ``step_fn(game, moves) -> game`` and ``moves_fn(t, game) -> i32[B, 4]``
    on the batched state.  Returns ``(states, moves)``: ``states`` the same
    NamedTuple with each field board ``board``'s values stacked over
    ``n_steps + 1`` steps (on the host), ``moves`` i32[n_steps, 4]."""
    def frame(game):
        return [t[board].detach().cpu() for t in _leaves(game)]

    frames, moves_hist = [frame(game0)], []
    game = game0
    for t in range(n_steps):
        mv = moves_fn(t, game)
        moves_hist.append(torch.as_tensor(mv)[board].detach().cpu()
                          .to(torch.int32))
        game = step_fn(game, mv)
        frames.append(frame(game))
    stacked = [torch.stack(xs) for xs in zip(*frames)]
    return _unflatten(game0, iter(stacked)), torch.stack(moves_hist)


def _npz_path(path: str) -> str:
    """``np.savez`` appends '.npz' to bare paths; normalise so that a save
    and a load with the same string meet."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_replay(path: str, states, moves) -> None:
    """Save a recorded game (any stacked NamedTuple) and its moves."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, moves=_host(moves),
             **{f"leaf_{i}": _host(a) for i, a in enumerate(_leaves(states))})


def load_replay(path: str, template):
    """Load a replay against ``template``, the state of ONE step (a
    NamedTuple of tensors or arrays, e.g. ``board_of(empty_cell_state(1,
    "cpu"))``).  Returns ``(states, moves)`` as CPU tensors.  The leaves are
    checked against the template, count and per-step shape, so a replay of
    another state type fails instead of filling the wrong fields."""
    with np.load(_npz_path(path)) as data:
        want = _leaves(template)
        n_saved = len([k for k in data.files if k.startswith("leaf_")])
        if n_saved != len(want):
            raise ValueError(
                f"replay at {path} has {n_saved} leaves but the template has "
                f"{len(want)}: recorded from a different state type?")
        loaded = []
        for i, leaf in enumerate(want):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape[1:]) != tuple(leaf.shape):
                raise ValueError(
                    f"replay leaf_{i} per-step shape {tuple(arr.shape[1:])} "
                    f"does not match the template's {tuple(leaf.shape)}")
            loaded.append(torch.from_numpy(arr))
        moves = torch.from_numpy(data["moves"])
    return _unflatten(template, iter(loaded)), moves


def replay_frame(states, t: int):
    """The state at step ``t`` of a stacked replay."""
    return _unflatten(states, iter([x[t] for x in _leaves(states)]))

"""Step-internal helpers (reference src/bboard/step_utility.cpp), batched.

Counterpart of ``pomcpp_tpu.engine.util``.  ``desired_position`` broadcasts
over any leading axes (the strategy code uses it); the rest take a batched
queue-encoded ``State`` (``core.state``) and per-board ``[B]`` indices.
"""

from __future__ import annotations

import torch

from ..core import queue as q
from ..core.constants import (
    AGENT_COUNT,
    C_EXTRABOMB,
    C_INCRRANGE,
    C_KICK,
    MAX_BOMBS,
    MOVE_DX,
    MOVE_DY,
)
from ..core.state import I32, State, add_at, read_at, write_at


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=I32, device=like.device)


def desired_position(x, y, move):
    """util::DesiredPosition (step_utility.cpp:9-31); IDLE/BOMB stay put.

    ``move`` holds move codes in [0, 6); ``x``, ``y`` and ``move``
    broadcast against each other.
    """
    move = torch.as_tensor(move)
    idx = move.long().clamp(0, len(MOVE_DX) - 1)
    return x + _table(MOVE_DX, move)[idx], y + _table(MOVE_DY, move)[idx]


def origin_position(x, y, move):
    """util::OriginPosition (step_utility.cpp:33-55): inverse of the move."""
    move = torch.as_tensor(move)
    idx = move.long().clamp(0, len(MOVE_DX) - 1)
    return x - _table(MOVE_DX, move)[idx], y - _table(MOVE_DY, move)[idx]


def fill_dest_pos(state: State, moves):
    """util::FillDestPos (step_utility.cpp:138-144), over all agents."""
    return desired_position(state.agent_x, state.agent_y, moves)


def fix_switch_move(state: State, des_x, des_y):
    """util::FixSwitchMove (step_utility.cpp:154-170).

    Two agents swapping cells both stay.  Replicates the reference's exact
    pair order (i ascending, j from i) and its use of *all* agent positions,
    including dead agents' stale coordinates.
    """
    ax, ay = state.agent_x, state.agent_y
    des_x, des_y = des_x.clone(), des_y.clone()
    for i in range(AGENT_COUNT):
        for j in range(i, AGENT_COUNT):
            swap = ((des_x[:, i] == ax[:, j]) & (des_y[:, i] == ay[:, j])
                    & (des_x[:, j] == ax[:, i]) & (des_y[:, j] == ay[:, i]))
            des_x[:, i] = torch.where(swap, ax[:, i], des_x[:, i])
            des_y[:, i] = torch.where(swap, ay[:, i], des_y[:, i])
            des_x[:, j] = torch.where(swap, ax[:, j], des_x[:, j])
            des_y[:, j] = torch.where(swap, ay[:, j], des_y[:, j])
    return des_x, des_y


def resolve_dependencies(state: State, des_x, des_y):
    """util::ResolveDependencies (step_utility.cpp:172-205).

    Returns (dependency[B, 4], roots[B, 5], root_count[B]).
    ``dependency[j] = i`` means "agent i moves after agent j" (i wants j's
    current cell).  Dead agents are roots.  Like the reference, a later
    agent targeting the same cell overwrites ``dependency[j]``, orphaning
    the earlier one (``engine.movement`` walks the chains the same way).
    ``roots`` is padded with -1.  ``roots.at[root_count].set`` never leaves
    the five slots (root_count <= 4 before the write); ``write_at`` would
    drop the write as JAX does if it did.
    """
    ax, ay = state.agent_x, state.agent_y
    dead = state.agent_dead
    b = ax.shape[0]
    dependency = torch.full((b, AGENT_COUNT), -1, dtype=I32, device=ax.device)
    roots = torch.full((b, AGENT_COUNT + 1), -1, dtype=I32, device=ax.device)
    root_count = torch.zeros(b, dtype=I32, device=ax.device)
    j_idx = torch.arange(AGENT_COUNT, device=ax.device)
    for i in range(AGENT_COUNT):
        match = ((j_idx != i) & ~dead & (des_x[:, i:i + 1] == ax)
                 & (des_y[:, i:i + 1] == ay))
        any_match = match.any(1)
        first_j = match.to(I32).argmax(1)
        dependency = write_at(dependency, first_j, i, any_match & ~dead[:, i])
        is_root = dead[:, i] | ~any_match
        roots = write_at(roots, root_count, i, is_root)
        root_count = root_count + is_root.to(I32)
    return dependency, roots, root_count


def has_dp_collision(state: State, des_x, des_y, i):
    """util::HasDPCollision (step_utility.cpp:264-277).

    Uses the shared (post-FixSwitchMove) destination array and *live* dead
    flags -- agents killed earlier in this step's walk no longer collide.
    ``i`` is ``[B]``.
    """
    j = torch.arange(AGENT_COUNT, device=des_x.device)
    mx, my = read_at(des_x, i), read_at(des_y, i)
    return ((j != i[:, None]) & ~state.agent_dead & (des_x == mx[:, None])
            & (des_y == my[:, None])).any(1)


def consume_powerup(state: State, agent_id, item, enable) -> State:
    """util::ConsumePowerup (step_utility.cpp:247-262), gated by ``enable``."""
    inc_b = (enable & (item == C_EXTRABOMB)).to(I32)
    inc_s = (enable & (item == C_INCRRANGE)).to(I32)
    kick = enable & (item == C_KICK)
    return state._replace(
        agent_max_bombs=add_at(state.agent_max_bombs, agent_id, inc_b),
        agent_strength=add_at(state.agent_strength, agent_id, inc_s),
        agent_can_kick=write_at(state.agent_can_kick, agent_id, True, kick),
    )


def fill_bomb_dest(state: State):
    """util::FillBombDestPos (step_utility.cpp:146-152).

    Returns logical-index arrays (dest_x[B, 20], dest_y[B, 20]); entries at
    or past bomb_count are the bombs' own (stale-slot) positions, never read
    by the reference either.
    """
    bx = q.logical_view(state.bombs.x, state.bomb_head)
    by = q.logical_view(state.bombs.y, state.bomb_head)
    bd = q.logical_view(state.bombs.dir, state.bomb_head)
    return desired_position(bx, by, bd.clamp(0, 4))


def reset_bomb_flags(state: State) -> State:
    """util::ResetBombFlags (step_utility.cpp:331-337): valid slots only."""
    n = MAX_BOMBS
    r = (torch.arange(n, device=state.board.device)
         - state.bomb_head[:, None]) % n
    valid = r < state.bomb_count[:, None]
    moved = torch.where(valid, False, state.bombs.moved)
    return state._replace(bombs=state.bombs._replace(moved=moved))

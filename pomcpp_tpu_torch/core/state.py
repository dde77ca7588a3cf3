"""Cell-class predicates, agent placement and the queue-encoded ``State``.

The helpers of ``pomcpp_tpu.core.state`` that the plane engine and the
SimpleAgent need (``is_powerup``, ``is_agent``, ``is_walkable``,
``flag_item``, ``put_agents_in_corners``), written for tensors whose leading
axis is the batch.

``Bombs``, ``Flames``, ``State`` and ``empty_state`` are the JAX package's
queue-encoded state of ONE board (no batch axis), with the same fields in
the same order: bomb and flame records live in fixed-size field arrays
whose logical element ``i`` is physical slot ``(head + i) % N``
(``core.queue``).  The port uses it as data only -- ``engine.cellular``'s
``from_state`` / ``to_state`` convert it to and from the plane state, and
the renderer draws it; the exact engine that steps it is not ported.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from .constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    BOMB_DEFAULT_STRENGTH,
    C_AGENT0,
    C_EXTRABOMB,
    C_INCRRANGE,
    C_KICK,
    C_PASSAGE,
    MAX_BOMBS,
    MAX_FLAMES,
    NUM_CELLS,
)

I32 = torch.int32


class Bombs(NamedTuple):
    """Bomb queue fields (SoA); logical order via ``State.bomb_head`` /
    ``bomb_count``."""

    x: torch.Tensor         # i32[MAX_BOMBS]
    y: torch.Tensor         # i32[MAX_BOMBS]
    id: torch.Tensor        # i32[MAX_BOMBS] owner agent
    strength: torch.Tensor  # i32[MAX_BOMBS] blast radius (stored at plant)
    timer: torch.Tensor     # i32[MAX_BOMBS] ticks until explosion
    dir: torch.Tensor       # i32[MAX_BOMBS] movement direction (0 = idle)
    moved: torch.Tensor     # bool[MAX_BOMBS] "moved this step" flag


class Flames(NamedTuple):
    """Flame queue fields (SoA); one record per exploded bomb."""

    x: torch.Tensor         # i32[MAX_FLAMES] origin x
    y: torch.Tensor         # i32[MAX_FLAMES] origin y
    timer: torch.Tensor     # i32[MAX_FLAMES] time left
    strength: torch.Tensor  # i32[MAX_FLAMES] ray length


class State(NamedTuple):
    """One board, queue-encoded: planes [121], agents [4], queues, scalars."""

    board: torch.Tensor       # i32 cell class (C_* codes)
    hidden_pow: torch.Tensor  # i32 powerup flag under WOOD / carried by FLAME
    flame_sig: torch.Tensor   # i32 owner signature (origin index) of FLAME

    agent_x: torch.Tensor
    agent_y: torch.Tensor
    agent_bomb_count: torch.Tensor
    agent_max_bombs: torch.Tensor
    agent_strength: torch.Tensor
    agent_can_kick: torch.Tensor  # bool[4]
    agent_dead: torch.Tensor      # bool[4]

    bombs: Bombs
    bomb_head: torch.Tensor   # i32 scalar
    bomb_count: torch.Tensor  # i32 scalar

    flames: Flames
    flame_head: torch.Tensor   # i32 scalar
    flame_count: torch.Tensor  # i32 scalar

    timestep: torch.Tensor     # i32 scalar
    alive_count: torch.Tensor  # i32 scalar


def empty_state(device=None) -> State:
    """All-passage board, agents at (0, 0) alive with default stats, empty
    queues, on ``device`` (None: the card)."""
    from ..device import resolve_device

    device = resolve_device(device)

    def zeros(n, dtype=I32):
        return torch.zeros(n, dtype=dtype, device=device)

    zb, zf = (lambda: zeros(MAX_BOMBS)), (lambda: zeros(MAX_FLAMES))
    return State(
        board=zeros(NUM_CELLS), hidden_pow=zeros(NUM_CELLS),
        flame_sig=zeros(NUM_CELLS),
        agent_x=zeros(AGENT_COUNT), agent_y=zeros(AGENT_COUNT),
        agent_bomb_count=zeros(AGENT_COUNT),
        agent_max_bombs=zeros(AGENT_COUNT) + 1,
        agent_strength=zeros(AGENT_COUNT) + BOMB_DEFAULT_STRENGTH,
        agent_can_kick=zeros(AGENT_COUNT, torch.bool),
        agent_dead=zeros(AGENT_COUNT, torch.bool),
        bombs=Bombs(zb(), zb(), zb(), zb(), zb(), zb(),
                    zeros(MAX_BOMBS, torch.bool)),
        bomb_head=zeros(()), bomb_count=zeros(()),
        flames=Flames(zf(), zf(), zf(), zf()),
        flame_head=zeros(()), flame_count=zeros(()),
        timestep=zeros(()), alive_count=zeros(()) + AGENT_COUNT,
    )


def cell_index(x, y):
    """Flat board index of (x, y)."""
    return x + BOARD_SIZE * y


def is_powerup(c):
    return (c >= C_EXTRABOMB) & (c <= C_KICK)


def is_agent(c):
    return c >= C_AGENT0


def is_walkable(c):
    return is_powerup(c) | (c == C_PASSAGE)


def flag_item(pwp):
    """Powerup flag -> cell class (reference State::FlagItem, bboard.cpp:182)."""
    out = torch.full_like(pwp, C_PASSAGE)
    out = torch.where(pwp == 1, C_EXTRABOMB, out)
    out = torch.where(pwp == 2, C_INCRRANGE, out)
    return torch.where(pwp == 3, C_KICK, out)


def put_agents_in_corners(cs, a0=0, a1=1, a2=2, a3=3):
    """Reference State::PutAgentsInCorners (bboard.cpp:322-333), batched.

    ``cs`` is any NamedTuple with ``board`` [B, 121] and ``agent_x`` /
    ``agent_y`` [B, 4].  Like the reference, only a1.x, a2.x, a2.y and a3.y
    are assigned; the other coordinates keep their (zero) values.
    """
    last = BOARD_SIZE - 1
    board = cs.board.clone()
    board[:, cell_index(0, 0)] = C_AGENT0 + a0
    board[:, cell_index(last, 0)] = C_AGENT0 + a1
    board[:, cell_index(last, last)] = C_AGENT0 + a2
    board[:, cell_index(0, last)] = C_AGENT0 + a3
    ax = cs.agent_x.clone()
    ay = cs.agent_y.clone()
    ax[:, a1] = last
    ax[:, a2] = last
    ay[:, a2] = last
    ay[:, a3] = last
    return cs._replace(board=board, agent_x=ax, agent_y=ay)

"""Cell-class predicates and agent placement on batched int32 tensors.

The helpers of ``pomcpp_tpu.core.state`` that the plane engine and the
SimpleAgent need (``is_powerup``, ``is_agent``, ``is_walkable``,
``flag_item``, ``put_agents_in_corners``),
written for tensors whose leading axis is the batch.  The queue-encoded
exact-engine ``State`` is not part of the port yet.
"""

from __future__ import annotations

import torch

from .constants import (
    BOARD_SIZE,
    C_AGENT0,
    C_EXTRABOMB,
    C_INCRRANGE,
    C_KICK,
    C_PASSAGE,
)

I32 = torch.int32


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

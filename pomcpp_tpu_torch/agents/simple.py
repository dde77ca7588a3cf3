"""The SimpleAgent's persistent state (``pomcpp_tpu.agents.simple``).

``SimpleAgentState`` holds one state per agent with leading batch axes
(``[B, 4]`` for all four agents of B boards): the recentPositions ring of
desired positions and the persistent moveQueue slots (agents.hpp:64-71).

``FsmState`` is the same state in the layout the chunk kernel carries: ten
i32[B, 4] arrays (ring slots x4, ring head, ring count, moveQueue slots
x4).  The ring is stored in logical order (slot 0 oldest, head always 0),
each slot as the code ``(x + 1) + 13 * (y + 1)``; a slot never written holds
14, the code of (0, 0).  ``convert.py`` maps one layout onto the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.state import I32
from ..device import resolve_device

RP_STALE = 14   # code of (0, 0): what a never-written ring slot reads as


class SimpleAgentState(NamedTuple):
    """Persistent per-agent FSM state."""

    rp_x: torch.Tensor      # i32[..., 4] recent desired positions ring
    rp_y: torch.Tensor      # i32[..., 4]
    rp_head: torch.Tensor   # i32[...]
    rp_count: torch.Tensor  # i32[...]
    mq_slots: torch.Tensor  # i32[..., 4] persistent moveQueue slots


class FsmState(NamedTuple):
    """The chunk kernel's FSM state: ten i32[B, 4] arrays."""

    rp0: torch.Tensor
    rp1: torch.Tensor
    rp2: torch.Tensor
    rp3: torch.Tensor
    rp_head: torch.Tensor
    rp_count: torch.Tensor
    mq0: torch.Tensor
    mq1: torch.Tensor
    mq2: torch.Tensor
    mq3: torch.Tensor


def simple_agent_init(shape=(), device=None) -> SimpleAgentState:
    """Fresh state for agents of batch shape ``shape`` (slots zeroed, as the
    oracle build's zero-initialised storage) on ``device`` (None: the card;
    ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    z = torch.zeros(tuple(shape) + (4,), dtype=I32, device=device)
    z0 = torch.zeros(tuple(shape), dtype=I32, device=device)
    return SimpleAgentState(rp_x=z, rp_y=z, rp_head=z0, rp_count=z0,
                            mq_slots=z)


def _has_rp_loop(ast: SimpleAgentState) -> torch.Tensor:
    """_HasRPLoop (simple_agent.cpp:24-35): rp[i] == rp[i+2] for i < count/2.

    Vacuously true for count < 2; i+2 wraps physically (stale slots for
    count < 4), exactly like FixedQueue::operator[].
    """
    i = torch.arange(2, device=ast.rp_x.device)
    li = ((ast.rp_head[..., None] + i) % 4).long()
    lj = ((ast.rp_head[..., None] + i + 2) % 4).long()
    active = i < torch.div(ast.rp_count, 2, rounding_mode="floor")[..., None]
    eq = ((ast.rp_x.gather(-1, li) == ast.rp_x.gather(-1, lj))
          & (ast.rp_y.gather(-1, li) == ast.rp_y.gather(-1, lj)))
    return (eq | ~active).all(-1)

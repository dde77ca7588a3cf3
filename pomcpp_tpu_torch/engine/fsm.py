"""The SimpleAgent FSM as the chunk kernel runs it, with its plain version.

Counterpart of ``pomcpp_tpu.engine.pallas_fsm`` (``fsm_block`` with
``swar_bfs`` and ``danger_map_tile``).  The kernel's state is the
ten-array ``FsmState`` (``agents/simple.py``); one act for B boards:

* ``fsm_act_plain(cs, fsm_state, rand)`` -- the plain version: the toolkit
  FSM (``agents.simple_cellular.simple_agent_cell_joint``) read from and
  written to the kernel layout;
* ``fsm_act(cs, fsm_state, rand, device=None)`` -- launches
  ``fsm_act_kernel`` (``csrc/fused_step.cu``: ``wl::fsm_act`` of
  ``csrc/fsm_warp.cuh``, one board per warp) through ``launch.fsm_act`` on
  a CUDA device, which adds one to ``_ext.LAUNCHES["fsm_act_kernel"]``; on
  the CPU it runs the plain version.  It is the one-act test bed of the
  device code that the simple chunk kernel runs every step.  The kernel
  reads the ``CellState`` in its own dtypes (bools as one byte), so for a
  state in those dtypes the wrapper launches the kernel and nothing else.

Both return ``(moves, fsm_state')``: the FSM's own moves i32[B, 4] (dead
agents' moves are not zeroed here; the chunk does that) and the next state
with head 0.  ``rand`` is i32[B, 4], one draw per agent.
"""

from __future__ import annotations

import torch

from .. import launch
from ..agents.simple import RP_STALE, FsmState
from ..agents.simple_cellular import simple_agent_cell_joint
from ..convert import fsm_to_simple_state, simple_state_to_fsm
from ..core.constants import AGENT_COUNT
from ..core.state import I32
from ..device import resolve_device
from .cellular import CellState


def simple_fsm_state_init(b: int, device=None) -> FsmState:
    """Fresh FSM state for ``b`` boards: ring slots at the stale code 14,
    head, count and moveQueue slots at 0 (``simple_fsm_state_init`` of the
    JAX package)."""
    device = resolve_device(device)
    rp = torch.full((b, AGENT_COUNT), RP_STALE, dtype=I32, device=device)
    z = torch.zeros((b, AGENT_COUNT), dtype=I32, device=device)
    return FsmState(rp, rp, rp, rp, z, z, z, z, z, z)


def fsm_act_plain(cs: CellState, fsm_state, rand):
    """Plain version of the FSM kernel (see the module docstring)."""
    asts = fsm_to_simple_state(FsmState(*fsm_state))
    moves, _, asts2 = simple_agent_cell_joint(cs, asts, rand)
    return moves, simple_state_to_fsm(asts2)


def fsm_act(cs: CellState, fsm_state, rand, device=None):
    """One SimpleAgent act for every agent of B boards.

    ``device=None`` runs ``fsm_act_kernel`` on the card; ``device="cpu"``
    the plain version.
    """
    device = resolve_device(device)
    card = launch.card(device)
    if card:
        return launch.fsm_act(*card, cs, fsm_state, rand)
    cs = CellState(*(t.to(device) for t in cs))
    fsm_state = FsmState(*(torch.as_tensor(t).to(device=device, dtype=I32)
                           for t in fsm_state))
    return fsm_act_plain(cs, fsm_state,
                         torch.as_tensor(rand).to(device=device, dtype=I32))

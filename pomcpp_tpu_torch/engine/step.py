"""The exact conformance step: ``step(state, moves) -> state``, batched.

Counterpart of ``pomcpp_tpu.engine.step`` (``bboard::Step``, reference
src/bboard/step.cpp:9-284), over a batch of queue-encoded ``State``s and
``moves`` i32[B, 4].  Phase order is the spec:

  0. tick flames (expire & reveal powerups)
  1. simultaneous agent movement (dependency-chain walk)
  2. bomb kinematics (block pass with bounce-back, then move pass)
  3. tick bombs (queue-front explosions, chained)

Like the reference, this function does NOT advance ``timestep`` -- the
environment does (environment.cpp:150).  It runs on whatever device the
state lives on; its loops read "is any board still active" on the host
(``trace.COUNTERS["host_reads"]`` counts those reads).
"""

from __future__ import annotations

import torch

from .. import trace
from ..core.state import I32, State
from . import util
from .bombs import bomb_block_pass, bomb_move_pass
from .flames import tick_bombs, tick_flames
from .movement import move_agents


def step(state: State, moves) -> State:
    """Apply one simultaneous step to every board; ``moves`` is i32[B, 4]."""
    moves = torch.as_tensor(moves).to(device=state.board.device, dtype=I32)

    # Phase 0: flames (step.cpp:15).
    state = tick_flames(state)

    # Old positions, captured before movement (step.cpp:21-24).
    old_x, old_y = state.agent_x, state.agent_y

    # Phase 1: agent movement (step.cpp:26-185).
    state, _, _ = move_agents(state, moves)

    # Phase 2: bomb kinematics (step.cpp:187-278).  Counts do not grow in
    # this phase: one host read bounds both passes.
    state = util.reset_bomb_flags(state)
    bdest_x, bdest_y = util.fill_bomb_dest(state)
    trace.COUNTERS["host_reads"] += 1
    n = int(state.bomb_count.max()) if state.bomb_count.numel() else 0
    state = bomb_block_pass(state, moves, bdest_x, bdest_y, old_x, old_y, n)
    state = bomb_move_pass(state, moves, bdest_x, bdest_y, n)

    # Phase 3: explosions (step.cpp:283).
    return tick_bombs(state)

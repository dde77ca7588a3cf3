"""Phase 1: simultaneous agent movement (reference src/bboard/step.cpp:21-185),
batched.

Counterpart of ``pomcpp_tpu.engine.movement``.  The reference walks agents
in dependency-chain order (an agent blocked by another's current cell moves
after it), jumping the loop index through the ``dependency`` links; the
walk here is the JAX package's 4-iteration loop whose agent index is a
per-board tensor, each iteration a fully masked update of the batch.

Replicated quirks:
* BOMB moves plant with lifetime BOMB_LIFETIME+1 (ticked the same step) and
  do NOT set the board cell -- the bomb appears when the agent walks away.
* In an ouroboros (4-cycle) rotation, a destination covered by any bomb is
  treated as a BOMB cell and moving onto an agent cell is allowed.
* Walking into flames kills and vacates the origin cell only if it is still
  owned by the victim.
* The passage branch restores the origin cell only if still owned by the
  mover; both bomb branches restore it unconditionally (step.cpp:125-136 vs
  152-159/171-179).
* Without kick, an agent still moves onto a bomb cell; phase 2 bounces it
  back (step.cpp:170-184).
* Agents orphaned by a dependency overwrite are never processed.
"""

from __future__ import annotations

import torch

from ..core import queue as q
from ..core.constants import (
    AGENT_COUNT,
    BOMB_LIFETIME,
    C_AGENT0,
    C_BOMB,
    C_FLAME,
    C_PASSAGE,
    M_BOMB,
    M_IDLE,
)
from ..core.state import (
    I32,
    State,
    cell_index,
    get_bomb_index,
    has_bomb,
    is_agent,
    is_out_of_bounds,
    index_col,
    is_powerup,
    plant_bomb,
    read_at,
    write_at,
)
from .flames import masked_kill
from . import util


def _process_agent(state: State, i, moves, des_x, des_y, ouroboros,
                   valid) -> State:
    """One iteration of the chain walk body (step.cpp:46-185) for agent
    ``i[b]`` of the boards of ``valid``; the other boards are left as they
    are (every write carries the mask)."""
    i_val = i
    i = index_col(i)   # one long column for every read and write of agent i
    m = read_at(moves, i)
    active = valid & ~read_at(state.agent_dead, i) & (m != M_IDLE)

    # --- BOMB: plant with life 11, no board item (step.cpp:52-56) ---
    is_plant = active & (m == M_BOMB)
    state = plant_bomb(state, read_at(state.agent_x, i),
                       read_at(state.agent_y, i), i_val, set_item=False,
                       life=BOMB_LIFETIME + 1, mask=is_plant)

    x, y = read_at(state.agent_x, i), read_at(state.agent_y, i)
    dx, dy = read_at(des_x, i), read_at(des_y, i)
    moving = active & ~is_plant & ~is_out_of_bounds(dx, dy)
    dc = index_col(cell_index(dx.clamp(0, 10), dy.clamp(0, 10)))
    oc = index_col(cell_index(x, y))

    item = read_at(state.board, dc)
    # Ouroboros: a bomb under any agent still blocks (step.cpp:70-82).
    item = torch.where(ouroboros & has_bomb(state, dx, dy), C_BOMB, item)

    origin_mine = read_at(state.board, oc) == C_AGENT0 + i_val
    vacate_val = torch.where(has_bomb(state, x, y), C_BOMB, C_PASSAGE)

    # --- Walking into flames (step.cpp:84-99) ---
    flame_death = moving & (item == C_FLAME)
    state = masked_kill(state, i, flame_death)
    board = write_at(state.board, oc, vacate_val, flame_death & origin_mine)
    state = state._replace(board=board)

    moving = (moving & ~flame_death
              & ~util.has_dp_collision(state, des_x, des_y, i_val))

    # --- Powerup pickup (step.cpp:111-114) ---
    powerup = moving & is_powerup(item)
    state = util.consume_powerup(state, i, item, powerup)
    item = torch.where(powerup, C_PASSAGE, item)

    move_passage = moving & ((item == C_PASSAGE) | (ouroboros & is_agent(item)))
    onto_bomb = moving & (item == C_BOMB)
    move_kick = onto_bomb & read_at(state.agent_can_kick, i)
    does_move = move_passage | onto_bomb

    # Vacate origin: ownership-checked for passage, unconditional for bombs.
    vacate = (move_passage & origin_mine) | onto_bomb
    board = write_at(state.board, oc, vacate_val, vacate)
    state = state._replace(
        board=write_at(board, dc, C_AGENT0 + i_val, does_move),
        agent_x=write_at(state.agent_x, i, dx, does_move),
        agent_y=write_at(state.agent_y, i, dy, does_move),
    )

    # Kick: set the first bomb at the destination moving (step.cpp:165-168).
    kicked = get_bomb_index(state, dx, dy)
    safe_idx = torch.where(kicked >= 0, kicked, 0)
    return state._replace(bombs=state.bombs._replace(dir=q.set_(
        state.bombs.dir, state.bomb_head, safe_idx, m,
        move_kick & (kicked >= 0))))


def move_agents(state: State, moves):
    """Phase 1 (step.cpp:21-185).  Returns (state, des_x, des_y)."""
    moves = moves.to(I32)
    des_x, des_y = util.fill_dest_pos(state, moves)
    des_x, des_y = util.fix_switch_move(state, des_x, des_y)
    dependency, roots, root_count = util.resolve_dependencies(
        state, des_x, des_y)
    ouroboros = root_count == 0

    i = torch.where(ouroboros, 0, roots[:, 0]).to(I32)
    root_idx = torch.zeros_like(i)
    for _ in range(AGENT_COUNT):
        # If the chain ended, pick the next root (the -1 padding of roots
        # makes the iteration a no-op; see util.resolve_dependencies).
        take_next_root = i == -1
        root_idx = root_idx + take_next_root.to(I32)
        i = torch.where(take_next_root,
                        read_at(roots, root_idx.clamp(0, AGENT_COUNT)), i)
        valid = i >= 0
        safe_i = torch.where(valid, i, 0)
        state = _process_agent(state, safe_i, moves, des_x, des_y, ouroboros,
                               valid)
        i = torch.where(valid, read_at(dependency, safe_i), -1)
    return state, des_x, des_y

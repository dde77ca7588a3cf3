"""SimpleAgent over ``CellState`` planes, all four agents of a batch at once.

Counterpart of ``pomcpp_tpu.agents.simple_cellular``: the decision cascade
of the reference SimpleAgent (simple_agent.cpp:51-115) computed with the
plane toolkit.  ``simple_agent_cell_joint(cs, asts, rands)`` is the JAX
module's ``simple_agent_cell_act`` vmapped over the four agents, with the
per-agent rand draws passed in; ``simple_agent_cell_act`` /
``simple_agent_cell_policy`` are the JAX module's one-agent act and
policy, over a batch of boards.

Dead agents follow the chunk kernel's rule (``pallas_fsm.fsm_block``), not
the JAX toolkit's: their BFS sources are pruned, so they never flee or
approach.  Live agents' moves, ``consumed`` flags and states are the JAX
module's, bit for bit; dead agents' moves are zeroed before they are
played, but their ring and moveQueue still advance, as in the kernel.
"""

from __future__ import annotations

import torch

from ..core.constants import BOARD_SIZE, M_BOMB, M_IDLE, NUM_CELLS
from ..core.state import I32, is_walkable
from ..engine.cellular import CellState
from ..engine.util import desired_position
from ..strategy.cellular_toolkit import (
    danger_map_cell,
    fill_reach_map,
    is_adjacent_enemy_cell,
    is_adjacent_wood_cell,
    move_towards_enemy_cell,
    move_towards_safe_place_cell,
    read_at,
    safe_directions_cell,
)
from ..strategy.moves import safe_condition, sort_directions
from .simple import SimpleAgentState, _has_rp_loop


def _inb(x, y):
    return (x >= 0) & (y >= 0) & (x < BOARD_SIZE) & (y < BOARD_SIZE)


def _danger_at(dmap, x, y):
    c = (x + BOARD_SIZE * y).clamp(0, NUM_CELLS - 1)
    return torch.where(_inb(x, y), read_at(dmap, c), 0)


def _walkable_at(cs, x, y):
    c = (x + BOARD_SIZE * y).clamp(0, NUM_CELLS - 1)
    return _inb(x, y) & is_walkable(read_at(cs.board, c))


def _set_slot(ring, slot, value):
    return ring.scatter(-1, slot.long()[..., None], value[..., None].to(I32))


def simple_agent_cell_joint(cs: CellState, asts: SimpleAgentState, rands,
                            dmap=None):
    """One decision for every agent of every board.

    ``asts``: state with leading axes [B, 4]; ``rands``: i32[B, 4], each
    agent's next intDist(0,4) draw.  Returns ``(moves, consumed, asts')``,
    moves i32[B, 4].  ``dmap`` lets a caller pass a danger map it already
    computed.
    """
    ax, ay = cs.agent_x, cs.agent_y
    rands = torch.as_tensor(rands).to(device=ax.device, dtype=I32)
    if dmap is None:
        dmap = danger_map_cell(cs)
    alive = ~cs.agent_dead
    r = fill_reach_map(cs)
    danger = _danger_at(dmap, ax, ay)

    # Path A: flee danger.
    in_danger = danger > 0
    m_safe = move_towards_safe_place_cell(dmap, r, danger)
    sx, sy = desired_position(ax, ay, m_safe)
    # A dead agent's IDLE "step" would test its own, now walkable, cell.
    a_ok = in_danger & alive & _walkable_at(cs, sx, sy) & safe_condition(
        _danger_at(dmap, sx, sy), 2)
    a_else = in_danger & ~a_ok

    # Shared moveQueue recompute.
    new_moves, mq_count = safe_directions_cell(cs, dmap, ax, ay)
    k = torch.arange(4, device=ax.device)
    slots = torch.where(k < mq_count[..., None], new_moves, asts.mq_slots)
    slots, mq_count = sort_directions(
        slots, mq_count, asts.rp_x, asts.rp_y, asts.rp_head, asts.rp_count,
        ax, ay)
    pick = (rands % 2).clamp(0, 3).long()[..., None]
    m_queue = torch.where(mq_count == 0, M_IDLE, slots.gather(-1, pick)[..., 0])

    # Path B: aggression.
    can_bomb = cs.agent_bomb_count < cs.agent_max_bombs
    adj1 = is_adjacent_enemy_cell(cs, 1)
    adj7 = is_adjacent_enemy_cell(cs, 7)
    rp_loop = _has_rp_loop(asts)
    m_enemy = move_towards_enemy_cell(cs, r, 7)
    ex, ey = desired_position(ax, ay, m_enemy)
    b3_ok = alive & _walkable_at(cs, ex, ey) & safe_condition(
        _danger_at(dmap, ex, ey), 5)
    wood_adj = is_adjacent_wood_cell(cs, 1)

    calm = ~in_danger
    b1 = calm & can_bomb & adj1
    b2 = calm & can_bomb & ~b1 & adj7 & rp_loop
    b3 = calm & can_bomb & ~b1 & ~b2 & adj7 & b3_ok
    b4 = calm & can_bomb & ~b1 & ~b2 & ~b3 & wood_adj
    c_path = calm & ~b1 & ~b2 & ~b3 & ~b4

    move = m_queue
    move = torch.where(b4, M_BOMB, move)
    move = torch.where(b3, m_enemy, move)
    move = torch.where(b2, rands % 4, move)
    move = torch.where(b1, M_BOMB, move)
    move = torch.where(a_else, m_queue, move)
    move = torch.where(a_ok, m_safe, move).to(I32)

    mq_empty = mq_count == 0
    consumed = (a_else & ~mq_empty) | b2 | (c_path & ~mq_empty)
    mq_written = a_else | c_path
    new_slots = torch.where(mq_written[..., None], slots, asts.mq_slots)

    # recentPositions ring: push the desired position of the final move.
    px, py = desired_position(ax, ay, move)
    full = asts.rp_count == 4
    head = torch.where(full, (asts.rp_head + 1) % 4, asts.rp_head)
    count = torch.where(full, asts.rp_count - 1, asts.rp_count)
    slot = (head + count) % 4
    asts2 = SimpleAgentState(
        rp_x=_set_slot(asts.rp_x, slot, px),
        rp_y=_set_slot(asts.rp_y, slot, py),
        rp_head=head.to(I32),
        rp_count=(count + 1).to(I32),
        mq_slots=new_slots.to(I32),
    )
    return move, consumed, asts2


def simple_agent_cell_act(cs: CellState, agent_id: int,
                          ast: SimpleAgentState, rand, dmap=None):
    """One decision of agent ``agent_id`` on every board.

    ``ast``: that agent's state, leading axis [B]; ``rand``: i32[B], its
    next intDist(0,4) draw.  Returns ``(moves i32[B], consumed bool[B],
    ast')``: the joint act's column ``agent_id`` (the other agents'
    decisions are computed and dropped).
    """
    b = cs.board.shape[0]
    rand = torch.as_tensor(rand).to(device=cs.board.device, dtype=I32)

    def four(t):
        return t[:, None].expand((b, 4) + tuple(t.shape[1:]))

    asts = SimpleAgentState(*map(four, ast))
    moves, consumed, asts2 = simple_agent_cell_joint(
        cs, asts, four(rand), dmap)
    return (moves[:, agent_id], consumed[:, agent_id],
            SimpleAgentState(*(t[:, agent_id] for t in asts2)))


def simple_agent_cell_policy(generator, cs: CellState, agent_id: int,
                             ast: SimpleAgentState):
    """Stateful one-agent policy: draws the rand on ``generator`` ->
    ``(moves i32[B], ast')``."""
    rand = torch.randint(0, 5, cs.board.shape[:1], generator=generator,
                         device=generator.device, dtype=I32)
    move, _, ast2 = simple_agent_cell_act(cs, agent_id, ast, rand)
    return move, ast2

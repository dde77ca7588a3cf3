"""The exact SimpleAgent (``pomcpp_tpu.agents.simple``) and its persistent
state.

``simple_agent_act`` is the reference's decision cascade
(simple_agent.cpp:51-129) over a batch of queue-encoded ``State``s with the
exact strategy toolkit (``strategy.rmap``, ``strategy.moves``);
``simple_agent_joint`` runs it for all four agents of every board.

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

from ..core.constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_WOOD,
    M_BOMB,
    M_IDLE,
    NUM_CELLS,
)
from ..core.state import I32, is_walkable, read_at
from ..device import resolve_device
from ..engine.util import desired_position

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


def simple_agent_init_batch(b: int, device=None) -> SimpleAgentState:
    """FSM state for all four agents of ``b`` boards (leading axes [b, 4])."""
    return simple_agent_init((b, AGENT_COUNT), device)


def _walkable_at(state, x, y):
    inb = (x >= 0) & (y >= 0) & (x < BOARD_SIZE) & (y < BOARD_SIZE)
    c = (x + BOARD_SIZE * y).clamp(0, NUM_CELLS - 1)
    return inb & is_walkable(read_at(state.board, c))


def simple_agent_act(state, agent_id, ast: SimpleAgentState, rand):
    """One decision of agent ``agent_id`` (int or ``[B]``) on every board of
    a queue-encoded ``State`` batch (simple_agent.cpp:51-129).

    ``ast``: that agent's state, leading axis [B]; ``rand``: i32[B], its
    next intDist(0, 4) draw.  Returns ``(move i32[B], consumed bool[B],
    ast')``.  The moveQueue slots persist across acts (only the count is
    reset, so the final pick can read a stale slot) and the ring holds
    desired positions, as in the JAX module.
    """
    from ..strategy.moves import (
        is_adjacent_enemy,
        is_adjacent_item,
        is_in_danger,
        move_towards_enemy,
        move_towards_safe_place,
        safe_condition,
        safe_directions,
        sort_directions,
    )
    from ..strategy.rmap import fill_rmap

    b, dev = state.board.shape[0], state.board.device
    if isinstance(agent_id, int):
        agent_id = torch.full((b,), agent_id, dtype=I32, device=dev)
    rand = torch.as_tensor(rand, device=dev).to(I32)
    ax, ay = read_at(state.agent_x, agent_id), read_at(state.agent_y, agent_id)
    r = fill_rmap(state, agent_id)
    danger = is_in_danger(state, ax, ay)

    # --- Path A: flee danger (simple_agent.cpp:57-71) ---
    in_danger = danger > 0
    m_safe = move_towards_safe_place(state, r, danger)
    sx, sy = desired_position(ax, ay, m_safe)
    a_ok = (in_danger & _walkable_at(state, sx, sy)
            & safe_condition(is_in_danger(state, sx, sy), 2))
    a_else = in_danger & ~a_ok

    # --- Shared moveQueue recompute (paths A-else and C): fresh moves
    # overlaid onto the persistent slots (only the count was reset) ---
    new_moves, mq_count = safe_directions(state, ax, ay)
    k = torch.arange(4, device=dev)
    slots = torch.where(k < mq_count[:, None], new_moves, ast.mq_slots)
    slots, mq_count = sort_directions(slots, mq_count, ast.rp_x, ast.rp_y,
                                      ast.rp_head, ast.rp_count, ax, ay)
    mq_empty = mq_count == 0
    m_queue = torch.where(mq_empty, M_IDLE,
                          read_at(slots, (rand % 2).clamp(0, 3)))

    # --- Path B: aggression (simple_agent.cpp:73-101) ---
    can_bomb = read_at(state.agent_bomb_count, agent_id) \
        < read_at(state.agent_max_bombs, agent_id)
    adj1 = is_adjacent_enemy(state, agent_id, 1)
    adj7 = is_adjacent_enemy(state, agent_id, 7)
    rp_loop = _has_rp_loop(ast)
    m_enemy = move_towards_enemy(state, r, 7)
    ex, ey = desired_position(ax, ay, m_enemy)
    b3_ok = (_walkable_at(state, ex, ey)
             & safe_condition(is_in_danger(state, ex, ey), 5))
    wood_adj = is_adjacent_item(state, agent_id, 1, C_WOOD)

    b1 = ~in_danger & can_bomb & adj1
    b2 = ~in_danger & can_bomb & ~b1 & adj7 & rp_loop
    b3 = ~in_danger & can_bomb & ~b1 & ~b2 & adj7 & b3_ok
    b4 = ~in_danger & can_bomb & ~b1 & ~b2 & ~b3 & wood_adj
    c_path = ~in_danger & ~b1 & ~b2 & ~b3 & ~b4

    move = torch.where(a_ok, m_safe, torch.where(
        a_else, m_queue, torch.where(
            b1, M_BOMB, torch.where(
                b2, rand % 4, torch.where(
                    b3, m_enemy, torch.where(b4, M_BOMB, m_queue)))))).to(I32)

    consumed = (a_else & ~mq_empty) | b2 | (c_path & ~mq_empty)
    mq_written = a_else | c_path
    new_slots = torch.where(mq_written[:, None], slots, ast.mq_slots)

    # --- recentPositions ring update (simple_agent.cpp:116-129) ---
    px, py = desired_position(ax, ay, move)
    full = ast.rp_count == 4
    head = torch.where(full, (ast.rp_head + 1) % 4, ast.rp_head)
    count = torch.where(full, ast.rp_count - 1, ast.rp_count)
    slot = ((head + count) % 4).long()[:, None]
    return move, consumed, SimpleAgentState(
        rp_x=ast.rp_x.scatter(1, slot, px.to(I32)[:, None]),
        rp_y=ast.rp_y.scatter(1, slot, py.to(I32)[:, None]),
        rp_head=head.to(I32), rp_count=(count + 1).to(I32),
        mq_slots=new_slots.to(I32))


def simple_agent_joint(state, asts: SimpleAgentState, rands):
    """``simple_agent_act`` of all four agents of every board in one call
    (the B boards' four agents as 4B rows).  ``asts`` has leading axes
    [B, 4], ``rands`` is i32[B, 4]; returns ``(moves [B, 4], consumed
    [B, 4], asts')``."""
    from ..core.state import map_state

    b, dev = state.board.shape[0], state.board.device
    rows = map_state(lambda t: t.repeat_interleave(AGENT_COUNT, 0), state)
    ids = torch.arange(AGENT_COUNT, dtype=I32, device=dev).repeat(b)
    flat = SimpleAgentState(*(t.reshape((b * AGENT_COUNT,) + t.shape[2:])
                              for t in asts))
    move, consumed, out = simple_agent_act(
        rows, ids, flat, torch.as_tensor(rands, device=dev).reshape(-1))
    return (move.reshape(b, AGENT_COUNT), consumed.reshape(b, AGENT_COUNT),
            SimpleAgentState(*(t.reshape((b, AGENT_COUNT) + t.shape[1:])
                               for t in out)))


def simple_agent_policy(generator, state, agent_id, ast: SimpleAgentState):
    """Stateful one-agent policy: draws its uniform [0, 4] rand on
    ``generator`` (in place of the JAX key) -> ``(move i32[B], ast')``."""
    rand = torch.randint(0, 5, state.board.shape[:1], generator=generator,
                         device=generator.device, dtype=I32)
    move, _, ast2 = simple_agent_act(state, agent_id, ast, rand)
    return move, ast2

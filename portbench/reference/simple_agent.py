"""The SimpleAgent in plain PyTorch, as the chunk kernel's FSM runs it.

Frozen copy, not an import: it was copied from the port at commit
d0a03242271a (``pomcpp_tpu_torch/agents/simple.py`` ``RP_STALE``,
``SimpleAgentState``, ``FsmState``, ``_has_rp_loop``; ``convert.py``
``simple_state_to_fsm``, ``fsm_to_simple_state``; ``strategy/moves.py``
``safe_condition``, ``sort_directions``; ``strategy/cellular_toolkit.py``
whole; ``agents/simple_cellular.py`` ``simple_agent_cell_joint``), with
``fsm_act_plain`` of ``engine/fsm.py`` as ``fsm_act``.  It imports nothing
of the port, of the JAX package or of JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rules import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_WOOD,
    I32,
    M_BOMB,
    M_DOWN,
    M_IDLE,
    M_LEFT,
    M_RIGHT,
    M_UP,
    NUM_CELLS,
    CellState,
    _push,
    desired_position,
    is_agent,
    is_walkable,
)


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


def simple_state_to_fsm(ast: SimpleAgentState) -> FsmState:
    """Kernel layout of a ``SimpleAgentState`` with leading axes [B, 4]."""
    j = torch.arange(4, device=ast.rp_x.device)
    phys = ((ast.rp_head[..., None] + j) % 4).long()
    code = (ast.rp_x + 1) + 13 * (ast.rp_y + 1)
    ring = code.gather(-1, phys).to(I32)
    return FsmState(*ring.unbind(-1), torch.zeros_like(ast.rp_head),
                    ast.rp_count.to(I32), *ast.mq_slots.to(I32).unbind(-1))


def fsm_to_simple_state(fsm) -> SimpleAgentState:
    """``SimpleAgentState`` (head 0) from the kernel layout."""
    ring = torch.stack(tuple(fsm[:4]), -1)
    return SimpleAgentState(
        rp_x=ring % 13 - 1, rp_y=torch.div(ring, 13, rounding_mode="floor") - 1,
        rp_head=torch.zeros_like(fsm[5]), rp_count=fsm[5],
        mq_slots=torch.stack(tuple(fsm[6:]), -1),
    )


SORT_APPLICATIONS = 8   # <= 4 original entries + <= 4 removals


def safe_condition(danger, min_time: int = 2):
    """_safe_condition (strategy.cpp:192-195)."""
    return (danger == 0) | (danger >= min_time)


def sort_directions(slots, count, rp_x, rp_y, rp_head, rp_count, x, y):
    """SortDirections (strategy.hpp:130-152) over the persistent 4-slot queue.

    ``slots``, ``rp_x``, ``rp_y``: [..., 4]; ``count``, ``rp_head``,
    ``rp_count``, ``x``, ``y``: [...].  Replicates the reference's
    RemoveAt+AddElem aliasing exactly: a visited move that is not last in
    the queue is deleted and the element that slid into its place is
    duplicated at the back; a visited move at the back stays put.  Returns
    ``(slots, count)``.
    """
    k = torch.arange(4, device=slots.device)
    logical = (rp_head[..., None] + k) % 4
    ring_x = rp_x.gather(-1, logical.long())
    ring_y = rp_y.gather(-1, logical.long())
    ring_live = k < rp_count[..., None]
    count_orig = count
    i = torch.zeros_like(count)
    removes = torch.zeros_like(count)
    for _ in range(SORT_APPLICATIONS):
        active = (i < count_orig) & (removes < 4) & (i >= 0)
        si = i.clamp(0, 3).long()[..., None]
        v = slots.gather(-1, si)[..., 0].clamp(0, 5)
        dx, dy = desired_position(x, y, v)
        vis = (ring_live & (ring_x == dx[..., None])
               & (ring_y == dy[..., None])).any(-1)
        do = active & vis
        # RemoveAt(i): shift logical (i, count) left by one.
        shift = (k >= i[..., None]) & (k < count[..., None] - 1)
        shifted = torch.where(shift, torch.roll(slots, -1, -1), slots)
        count2 = count - 1
        # AddElem(q[i]) after the shift (the aliasing quirk).
        val = shifted.gather(-1, si)
        appended = shifted.scatter(-1, count2.clamp(0, 3).long()[..., None],
                                   val)
        slots = torch.where(do[..., None], appended, slots)
        count = torch.where(do, count2 + 1, count)
        i = torch.where(do, i - 1, i) + 1
        removes = removes + do.to(removes.dtype)
    return slots, count


BIG = (2 ** 31 - 1) // 4   # "unreachable" distance, as the JAX module's _BIG


# Reference TryAdd neighbour order (strategy.cpp:82-89): (y+1), (y-1),
# (x+1), (x-1) == directions DOWN, UP, RIGHT, LEFT.
PRIORITY = (M_DOWN, M_UP, M_RIGHT, M_LEFT)


# SafeDirections probe order (strategy.cpp:197-221).
SAFE_ORDER = ((1, 0, M_RIGHT), (-1, 0, M_LEFT), (0, 1, M_DOWN), (0, -1, M_UP))


class ReachMap(NamedTuple):
    dist: torch.Tensor    # i32[B, 4, 121]; BIG = unreachable, 0 = source
    root: torch.Tensor    # i32[B, 4, 121]; first move from the source (0 none)
    source: torch.Tensor  # i32[B, 4] flat index of each agent's cell


def _cells(device):
    c = torch.arange(NUM_CELLS, dtype=I32, device=device)
    return c % BOARD_SIZE, c // BOARD_SIZE


def read_at(plane, cell):
    """plane [B, 121] or [B, 4, 121] read at cell [B, 4] (on-board)."""
    idx = cell.long()[..., None]
    if plane.dim() == 2:
        return plane.gather(1, idx[..., 0])
    return plane.gather(2, idx)[..., 0]


def danger_map_cell(cs: CellState) -> torch.Tensor:
    """i32[B, 121] min ticks-to-blast over covering bombs, 0 where none
    (IsInDanger, strategy.cpp:229-249: pure cross geometry, stored strength,
    no chains; blasts pass through walls and never wrap rows)."""
    has_bomb = cs.bomb_timer > 0
    danger = torch.where(has_bomb, cs.bomb_timer, BIG)
    s0 = torch.where(has_bomb, cs.bomb_strength, 0)
    max_k = min(int(s0.max()) if s0.numel() else 0, BOARD_SIZE - 1)
    planes = [(cs.bomb_timer, s0)] * 4
    for k in range(1, max_k + 1):
        moved = []
        for d, (t_sh, s_sh) in zip((1, 2, 3, 4), planes):
            t_sh = _push(t_sh, d, 0)
            s_sh = _push(s_sh, d, 0)
            cover = (t_sh > 0) & (s_sh >= k)
            danger = torch.minimum(danger, torch.where(cover, t_sh, BIG))
            moved.append((t_sh, s_sh))
        planes = moved
    return torch.where(danger == BIG, 0, danger).to(I32)


def fill_reach_map(cs: CellState) -> ReachMap:
    """BFS distances + root-direction labels from each live agent's cell.

    Agents are path targets but are not expanded through (strategy.cpp:
    50-52); each agent's own cell expands even though it is not walkable.
    A dead agent's map is all unreachable.
    """
    dev = cs.board.device
    src = cs.agent_x + BOARD_SIZE * cs.agent_y
    src_oh = torch.arange(NUM_CELLS, device=dev) == src[..., None]
    src_oh = src_oh & ~cs.agent_dead[..., None]
    walk = is_walkable(cs.board)[:, None, :]
    enterable = walk | is_agent(cs.board)[:, None, :]
    expandable = walk | src_oh
    dist = torch.where(src_oh, 0, BIG).to(I32)
    root = torch.zeros_like(dist)
    from_src = {mv: _push(src_oh, mv, False) for mv in PRIORITY}
    while True:
        nd, nr = dist, root
        for mv in PRIORITY:
            # The neighbour that a move in direction mv leaves feeds this
            # cell when it expanded; cells next to the source take mv itself.
            cand_d = _push(torch.where(expandable, dist, BIG), mv, BIG) + 1
            cand_r = torch.where(from_src[mv], mv, _push(root, mv, 0))
            better = enterable & (cand_d < nd)
            nd = torch.where(better, cand_d, nd)
            nr = torch.where(better, cand_r, nr)
        changed = bool((nd != dist).any())
        dist, root = nd.to(I32), nr.to(I32)
        if not changed:
            break
    return ReachMap(dist=dist, root=root, source=src.to(I32))


def _first_masked(mask) -> torch.Tensor:
    """First cell index with mask set along the last axis, or -1."""
    first = mask.to(torch.uint8).argmax(-1).to(I32)
    return torch.where(mask.any(-1), first, -1)


def move_towards_cell(r: ReachMap, cell) -> torch.Tensor:
    """First move from each source toward ``cell`` [B, 4] (label lookup)."""
    reachable = read_at(r.dist, cell) < BIG
    return torch.where(reachable, read_at(r.root, cell), M_IDLE).to(I32)


def move_towards_safe_place_cell(dmap, r: ReachMap, radius) -> torch.Tensor:
    """MoveTowardsSafePlace (strategy.cpp:122-141) with its buggy window
    bounds; safety = safe_condition(danger, 2).  ``radius``: [B, 4]."""
    cx, cy = _cells(dmap.device)
    ox = (r.source % BOARD_SIZE)[..., None]
    oy = (r.source // BOARD_SIZE)[..., None]
    rad = radius[..., None]
    window = (cy >= oy - rad) & (cy < rad) & (cx >= ox - rad) & (cx < rad)
    manh = (cx - ox).abs() + (cy - oy).abs()
    safe = ((dmap == 0) | (dmap >= 2))[:, None, :]
    mask = (window & (manh <= rad) & (r.dist != 0) & (r.dist < BIG) & safe)
    c = _first_masked(mask)
    return torch.where(c >= 0, move_towards_cell(r, c.clamp(min=0)), M_IDLE)


def move_towards_enemy_cell(cs: CellState, r: ReachMap, radius) -> torch.Tensor:
    """MoveTowardsEnemy (strategy.cpp:163-186): toward the first live agent
    (id order) within manhattan ``radius`` not on the source cell."""
    ox = (r.source % BOARD_SIZE)[..., None]
    oy = (r.source // BOARD_SIZE)[..., None]
    ex, ey = cs.agent_x[:, None, :], cs.agent_y[:, None, :]
    manh = (ex - ox).abs() + (ey - oy).abs()
    at_src = (ex == ox) & (ey == oy)
    ok = ~cs.agent_dead[:, None, :] & ~at_src & (manh <= radius)
    j = ok.to(torch.uint8).argmax(-1, keepdim=True)
    c = (ex + BOARD_SIZE * ey).expand_as(ok).gather(-1, j)[..., 0]
    return torch.where(ok.any(-1), move_towards_cell(r, c), M_IDLE)


def safe_directions_cell(cs: CellState, dmap, x, y):
    """SafeDirections (strategy.cpp:197-221) at (x, y) [B, 4]; returns
    (moves i32[B, 4, 4], count i32[B, 4])."""
    moves = torch.zeros(x.shape + (4,), dtype=I32, device=x.device)
    count = torch.zeros_like(x)
    slot = torch.arange(4, device=x.device)
    for dx, dy, mv in SAFE_ORDER:
        nx, ny = x + dx, y + dy
        inb = (nx >= 0) & (ny >= 0) & (nx < BOARD_SIZE) & (ny < BOARD_SIZE)
        c = (nx + BOARD_SIZE * ny).clamp(0, NUM_CELLS - 1)
        d = read_at(dmap, c)
        ok = inb & is_walkable(read_at(cs.board, c)) & ((d == 0) | (d >= 2))
        at = slot == count[..., None]
        moves = torch.where(at & ok[..., None], mv, moves)
        count = count + ok.to(I32)
    return moves, count


def is_adjacent_enemy_cell(cs: CellState, distance) -> torch.Tensor:
    """bool[B, 4]: another live agent within manhattan ``distance``."""
    ax, ay = cs.agent_x[..., None], cs.agent_y[..., None]
    manh = (cs.agent_x[:, None, :] - ax).abs() + (cs.agent_y[:, None, :] - ay).abs()
    other = ~torch.eye(AGENT_COUNT, dtype=torch.bool, device=ax.device)
    return (other & ~cs.agent_dead[:, None, :] & (manh <= distance)).any(-1)


def is_adjacent_wood_cell(cs: CellState, distance) -> torch.Tensor:
    """bool[B, 4]: a wood cell within manhattan ``distance``."""
    cx, cy = _cells(cs.board.device)
    manh = ((cx - cs.agent_x[..., None]).abs()
            + (cy - cs.agent_y[..., None]).abs())
    return ((manh <= distance) & (cs.board == C_WOOD)[:, None, :]).any(-1)


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



def fsm_act(cs: CellState, fsm_state, rand):
    """One act of the FSM for every agent of every board -> ``(moves,
    fsm_state')`` in the kernel's layout (``fsm_act_plain``)."""
    asts = fsm_to_simple_state(FsmState(*fsm_state))
    moves, _, asts2 = simple_agent_cell_joint(cs, asts, rand)
    return moves, simple_state_to_fsm(asts2)

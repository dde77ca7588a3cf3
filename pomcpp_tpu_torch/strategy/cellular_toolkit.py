"""Plane-based strategy primitives over ``CellState`` planes, batched.

Counterpart of ``pomcpp_tpu.strategy.cellular_toolkit``.  Where the JAX
functions take one board and one ``agent_id``, these take a batch of boards
and answer for all four agents at once: per-agent results are ``[B, 4]``,
per-agent planes ``[B, 4, 121]``.  The rules are the JAX module's, including
its documented divergences from the exact toolkit:

* BFS predecessors come from parallel relaxation with a fixed direction
  priority (DOWN, UP, RIGHT, LEFT -- the reference's TryAdd order) instead
  of FIFO discovery order; equal-distance tie-breaks can differ.
* ``move_towards_position`` is replaced by root-direction labels: each
  reachable cell knows which first step from the source leads to it.

One rule is the chunk kernel's rather than the JAX toolkit's:
``fill_reach_map`` prunes dead agents' sources (``pallas_fsm.swar_bfs``),
so a dead agent reaches nothing.  Live agents' maps are unchanged by it.

Data-dependent loops (the danger map's radius, the BFS rounds) run until no
board of the batch needs another round; extra rounds are no-ops for the
boards that are done.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_WOOD,
    M_DOWN,
    M_IDLE,
    M_LEFT,
    M_RIGHT,
    M_UP,
    NUM_CELLS,
)
from ..core.state import I32, is_agent, is_walkable
from ..engine.cellular import CellState, _push

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

"""Danger model, path-following move selectors and local scans, batched.

Counterpart of ``pomcpp_tpu.strategy.moves`` (reference
src/bboard/strategy.cpp:99-338, include/strategy.hpp:130-172).  The
functions of the exact SimpleAgent take a batch of queue-encoded ``State``s
and a per-board agent id; ``safe_condition`` and ``sort_directions`` (the
plane SimpleAgent's too) broadcast over any leading axes.  Sequential
first-match scans are the least matching flat index, the reference's loop
order (y outer ascending, x inner ascending, flat index x + 11*y).

Deliberately replicated bug: ``MoveTowardsSafePlace`` iterates
``y in [originY - radius, radius)`` and ``x in [originX - radius, radius)``
-- the upper bounds should be ``origin + radius`` but the reference uses
bare ``radius`` (strategy.cpp:126-128).
"""

from __future__ import annotations

import torch

from ..core import queue as q
from ..core.constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    M_DOWN,
    M_IDLE,
    M_LEFT,
    M_RIGHT,
    M_UP,
    MAX_BOMBS,
    NUM_CELLS,
)
from ..core.state import I32, State, is_powerup, is_walkable, read_at
from ..engine.flames import masked_loop
from ..engine.util import desired_position
from .rmap import RMap

SORT_APPLICATIONS = 8   # <= 4 original entries + <= 4 removals
_BIG = 2 ** 31 - 1


def _cells(device):
    c = torch.arange(NUM_CELLS, dtype=I32, device=device)
    return c % BOARD_SIZE, c // BOARD_SIZE


def is_in_bomb_range(x, y, s, px, py):
    """IsInBombRange (strategy.hpp:167-172): cross of radius s around (x,y)."""
    return (((py == y) & ((px - x).abs() <= s))
            | ((px == x) & ((py - y).abs() <= s)))


def _bombs(state: State):
    """Logical x, y, strength, timer ``[B, 20]`` and the live slots."""
    h = state.bomb_head
    valid = (torch.arange(MAX_BOMBS, device=h.device)
             < state.bomb_count[:, None])
    return (*(q.logical_view(f, h) for f in (state.bombs.x, state.bombs.y,
                                             state.bombs.strength,
                                             state.bombs.timer)), valid)


def danger_map(state: State) -> torch.Tensor:
    """Per-cell IsInDanger (strategy.cpp:229-249), i32[B, 121]: the least
    stored timer over the live bombs whose cross covers the cell, 0 where
    none does (stored strength, no chains -- the reference's TODO at
    strategy.cpp:232 is part of the spec)."""
    bx, by, bs, bt, valid = _bombs(state)
    x, y = _cells(bx.device)
    cover = valid[:, None, :] & is_in_bomb_range(
        bx[:, None, :], by[:, None, :], bs[:, None, :], x[None, :, None],
        y[None, :, None])
    m = torch.where(cover, bt[:, None, :], _BIG).amin(2)
    return torch.where(m == _BIG, 0, m).to(I32)


def is_in_danger(state: State, x, y) -> torch.Tensor:
    """IsInDanger at one position per board (strategy.cpp:229-249)."""
    bx, by, bs, bt, valid = _bombs(state)
    cover = valid & is_in_bomb_range(bx, by, bs, x[:, None], y[:, None])
    m = torch.where(cover, bt, _BIG).amin(1)
    return torch.where(m == _BIG, 0, m).to(I32)


def safe_condition(danger, min_time: int = 2):
    """_safe_condition (strategy.cpp:192-195)."""
    return (danger == 0) | (danger >= min_time)


def move_towards_position(r: RMap, target) -> torch.Tensor:
    """MoveTowardsPosition (strategy.cpp:99-120): predecessor walk to the
    source, per board (the JAX loop at strategy/moves.py:118 as a masked
    loop).

    Walks the predecessor chain from ``target`` (flat index ``[B]``) until
    the predecessor is the source, then returns the first step's direction;
    a cell with distance 0 on the way means unreachable -> IDLE.
    """
    sx = r.source % BOARD_SIZE
    sy = torch.div(r.source, BOARD_SIZE, rounding_mode="floor")

    def body(carry):
        curr, result, done, n = carry
        live = ~done & (n < NUM_CELLS + 2)
        p = read_at(r.pred, curr)
        at_src = p == r.source
        cx = curr % BOARD_SIZE
        cy = torch.div(curr, BOARD_SIZE, rounding_mode="floor")
        mv = torch.where(cx > sx, M_RIGHT, torch.where(
            cx < sx, M_LEFT, torch.where(cy > sy, M_DOWN, M_UP)))
        unreachable = ~at_src & (read_at(r.dist, curr) == 0)
        res = torch.where(at_src, mv, torch.where(unreachable, M_IDLE, result))
        return (torch.where(live, p, curr), torch.where(live, res, result),
                torch.where(live, at_src | unreachable, done),
                n + live.to(I32))

    b, dev = r.source.shape[0], r.source.device
    zero = torch.zeros(b, dtype=I32, device=dev)
    target = torch.as_tensor(target, device=dev).to(I32).expand(b)
    _, result, _, _ = masked_loop(
        body, (target, zero, torch.zeros(b, dtype=torch.bool, device=dev),
               zero),
        lambda c: ~c[2] & (c[3] < NUM_CELLS + 2), NUM_CELLS + 2)
    return result.to(I32)


def _first_cell_match(mask) -> torch.Tensor:
    """First flat index with ``mask`` set per board, or -1 (row-major =
    the reference's order).  ``argmax`` of the int mask keeps the first
    index; an all-False row answers -1, not ``jnp.argmax``'s 0."""
    return torch.where(mask.any(1), mask.to(I32).argmax(1).to(I32), -1)


def _towards_first(r: RMap, mask) -> torch.Tensor:
    c = _first_cell_match(mask)
    return torch.where(c >= 0, move_towards_position(r, c.clamp(min=0)),
                       M_IDLE).to(I32)


def _origin(r: RMap):
    return (r.source % BOARD_SIZE)[:, None], \
        torch.div(r.source, BOARD_SIZE, rounding_mode="floor")[:, None]


def move_towards_safe_place(state: State, r: RMap, radius) -> torch.Tensor:
    """MoveTowardsSafePlace (strategy.cpp:122-141), buggy bounds included;
    ``radius`` ``[B]``."""
    ox, oy = _origin(r)
    x, y = _cells(ox.device)
    radius = torch.as_tensor(radius, device=ox.device)
    rad = radius[:, None] if radius.dim() else radius
    window = (y >= oy - rad) & (y < rad) & (x >= ox - rad) & (x < rad)
    manh = (x - ox).abs() + (y - oy).abs()
    mask = (window & (manh <= rad) & (r.dist != 0)
            & safe_condition(danger_map(state)))
    return _towards_first(r, mask)


def move_towards_powerup(state: State, r: RMap, radius) -> torch.Tensor:
    """MoveTowardsPowerup (strategy.cpp:143-161): first powerup in the
    diamond."""
    ox, oy = _origin(r)
    x, y = _cells(ox.device)
    manh = (x - ox).abs() + (y - oy).abs()
    return _towards_first(r, (manh <= radius) & is_powerup(state.board))


def move_towards_enemy(state: State, r: RMap, radius) -> torch.Tensor:
    """MoveTowardsEnemy (strategy.cpp:163-186): first live in-range agent.

    Skips dead agents and any agent standing on the source cell (which
    includes the owner), in agent-id order.
    """
    ox, oy = _origin(r)
    manh = (state.agent_x - ox).abs() + (state.agent_y - oy).abs()
    at_src = (state.agent_x == ox) & (state.agent_y == oy)
    ok = ~state.agent_dead & ~at_src & (manh <= radius)
    i = ok.to(I32).argmax(1)
    c = read_at(state.agent_x, i) + BOARD_SIZE * read_at(state.agent_y, i)
    return torch.where(ok.any(1), move_towards_position(r, c),
                       M_IDLE).to(I32)


# SafeDirections probe order: RIGHT, LEFT, DOWN, UP (strategy.cpp:197-221).
_SAFE_ORDER = ((1, 0, M_RIGHT), (-1, 0, M_LEFT), (0, 1, M_DOWN),
               (0, -1, M_UP))


def safe_directions(state: State, x, y):
    """SafeDirections (strategy.cpp:197-221).

    Returns ``(moves i32[B, 4], count [B])``: the first ``count`` entries
    are the safe moves in probe order; the remaining slots are 0.
    """
    b, dev = x.shape[0], x.device
    moves = torch.zeros((b, 4), dtype=I32, device=dev)
    count = torch.zeros(b, dtype=I32, device=dev)
    slot = torch.arange(4, device=dev)
    for dx, dy, mv in _SAFE_ORDER:
        nx, ny = x + dx, y + dy
        inb = (nx >= 0) & (ny >= 0) & (nx < BOARD_SIZE) & (ny < BOARD_SIZE)
        c = (nx + BOARD_SIZE * ny).clamp(0, NUM_CELLS - 1)
        ok = (inb & is_walkable(read_at(state.board, c))
              & safe_condition(is_in_danger(state, nx, ny)))
        here = ok[:, None] & (slot == count.clamp(0, 3)[:, None])
        moves = torch.where(here, mv, moves)
        count = count + ok.to(I32)
    return moves, count


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


def is_adjacent_enemy(state: State, agent_id, distance) -> torch.Tensor:
    """IsAdjacentEnemy (strategy.cpp:297-313): live enemy within manhattan d."""
    ax = read_at(state.agent_x, agent_id)[:, None]
    ay = read_at(state.agent_y, agent_id)[:, None]
    j = torch.arange(AGENT_COUNT, device=ax.device)
    manh = (state.agent_x - ax).abs() + (state.agent_y - ay).abs()
    agent_id = torch.as_tensor(agent_id, device=ax.device)
    me = j == (agent_id[:, None] if agent_id.dim() else agent_id)
    return (~me & ~state.agent_dead & (manh <= distance)).any(1)


def is_adjacent_item(state: State, agent_id, distance, item) -> torch.Tensor:
    """IsAdjacentItem (strategy.cpp:315-337): item within manhattan d.

    Like the reference, WOOD matches wood with any hidden-powerup flag (the
    flag lives in its own plane here).
    """
    ax = read_at(state.agent_x, agent_id)[:, None]
    ay = read_at(state.agent_y, agent_id)[:, None]
    x, y = _cells(ax.device)
    manh = (x - ax).abs() + (y - ay).abs()
    return ((manh <= distance) & (state.board == item)).any(1)

"""Reachability map: BFS distances + predecessor tree (reference RMap),
batched.

Counterpart of ``pomcpp_tpu.strategy.rmap``.  The reference fills an
``RMap`` per agent per step with a FIFO BFS (strategy.cpp:37-93) whose
pop/push order is observable: the predecessor tree (and so every
``MoveTowards*`` decision) depends on the neighbour visit order (0, +1),
(0, -1), (+1, 0), (-1, 0) and the FIFO discipline.  Here it is a masked
loop over an explicit queue of flat cell indices per board, one pop an
iteration, at most 121 pushes (+ the source) per board; the loop ends when
no board's queue holds a cell.

Conventions kept from the reference:
* the distance plane is 0 for both "unvisited" and the source itself
  (RMap::GetDistance, strategy.cpp:27-30 -- the ambiguity is load-bearing
  in ``MoveTowardsPosition``'s unreachable check, strategy.cpp:110-113);
* agent cells get a distance and a predecessor but are not expanded
  (strategy.cpp:50-52);
* ``info`` bit 0 accumulates "a popped cell within my own bomb range has
  distance < 10" (strategy.cpp:77-80); the source always sets it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import BOARD_SIZE, NUM_CELLS
from ..core.state import I32, State, is_agent, is_walkable, read_at, write_at
from ..engine.flames import masked_loop


class RMap(NamedTuple):
    dist: torch.Tensor    # i32[B, 121]; 0 = unvisited or source
    pred: torch.Tensor    # i32[B, 121]; predecessor flat index
    source: torch.Tensor  # i32[B] flat index of the BFS source
    info: torch.Tensor    # i32[B] bitflags (bit 0: own bomb endangers a
    #                       reachable cell)


def is_reachable(r: RMap, c) -> torch.Tensor:
    """IsReachable (strategy.hpp:60-66): nonzero distance or the source;
    ``c`` in [0, 121)."""
    return (read_at(r.dist, c) != 0) | (c == r.source)


# Neighbour offsets in the reference's TryAdd order (strategy.cpp:82-89).
_NEIGH = ((0, 1), (0, -1), (1, 0), (-1, 0))


def fill_rmap(state: State, agent_id) -> RMap:
    """FillRMap (strategy.cpp:58-93): exact-order BFS from the agent's cell
    (``agent_id`` an int or ``[B]``)."""
    b, dev = state.board.shape[0], state.board.device
    if isinstance(agent_id, int):
        agent_id = torch.full((b,), agent_id, dtype=I32, device=dev)
    x0 = read_at(state.agent_x, agent_id)
    y0 = read_at(state.agent_y, agent_id)
    src = (x0 + BOARD_SIZE * y0).to(I32)
    strength = read_at(state.agent_strength, agent_id)
    board = state.board

    zeros = torch.zeros((b, NUM_CELLS), dtype=I32, device=dev)
    queue = zeros.clone()
    queue[:, 0] = src
    one = torch.ones(b, dtype=I32, device=dev)

    def body(carry):
        dist, pred, queue, head, count, info = carry
        active = count > 0
        c = read_at(queue, head % NUM_CELLS)
        cx, cy = c % BOARD_SIZE, torch.div(c, BOARD_SIZE, rounding_mode="floor")
        head = head + active.to(I32)
        count = count - active.to(I32)
        d = read_at(dist, c)

        # info bit (strategy.cpp:77-80): own-bomb cross covers popped cell.
        in_range = (((cy == y0) & ((cx - x0).abs() <= strength))
                    | ((cx == x0) & ((cy - y0).abs() <= strength)))
        info = info | (active & in_range & (d < 10)).to(I32)

        for dx, dy in _NEIGH:
            nx, ny = cx + dx, cy + dy
            n = nx + BOARD_SIZE * ny
            nc = n.clamp(0, NUM_CELLS - 1)
            item = read_at(board, nc)
            ok = (active & ((nx != x0) | (ny != y0))  # never re-add the source
                  & (nx >= 0) & (ny >= 0) & (nx < BOARD_SIZE)
                  & (ny < BOARD_SIZE) & (read_at(dist, nc) == 0)
                  & (is_walkable(item) | is_agent(item)))
            pred = write_at(pred, nc, c, ok)
            dist = write_at(dist, nc, d + 1, ok)
            push = ok & ~is_agent(item)
            queue = write_at(queue, (head + count) % NUM_CELLS, n, push)
            count = count + push.to(I32)
        return dist, pred, queue, head, count, info

    dist, pred, _, _, _, info = masked_loop(
        body, (zeros, zeros, queue, zeros[:, 0], one, zeros[:, 0]),
        lambda carry: carry[4] > 0, NUM_CELLS + 1)
    return RMap(dist=dist, pred=pred, source=src, info=info)

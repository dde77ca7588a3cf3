"""Batched random boards on a ``torch.Generator``.

Counterpart of ``random_board_fast`` / ``random_cell_state`` in
``pomcpp_tpu.core.board_gen``, with the same distribution (not the same
bits): each cell is rigid w.p. 1/7 and wood w.p. 1/7; each wood cell carries
a hidden powerup flag w.p. 1/2, drawn uniformly from [1, 4] (4 reads as
"empty wood" through ``& 0b11``); agents stand in the corners, in seat
order or, with ``randomize_positions``, in a uniformly drawn permutation.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_AGENT0,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    NUM_CELLS,
)
from .state import I32, put_agents_in_corners

# Corner order of ``put_agents_in_corners``: (0,0), (10,0), (10,10), (0,10).
CORNER_X = (0, BOARD_SIZE - 1, BOARD_SIZE - 1, 0)
CORNER_Y = (0, 0, BOARD_SIZE - 1, BOARD_SIZE - 1)


def random_board_fast(b: int, generator: torch.Generator):
    """(board, hidden_pow) planes i32[b, 121] on the generator's device."""
    dev = generator.device
    tmp = torch.randint(0, 7, (b, NUM_CELLS), generator=generator, device=dev)
    board = torch.full((b, NUM_CELLS), C_PASSAGE, dtype=I32, device=dev)
    board = torch.where(tmp == 1, C_RIGID, board)
    board = torch.where(tmp == 2, C_WOOD, board)
    sel = torch.rand((b, NUM_CELLS), generator=generator, device=dev) < 0.5
    flags = torch.randint(1, 5, (b, NUM_CELLS), generator=generator,
                          device=dev, dtype=I32)
    hidden = torch.where((board == C_WOOD) & sel, flags, 0)
    return board, hidden


def put_agents_in_corners_perm(cs, perm):
    """``put_agents_in_corners`` with a per-board seat assignment.

    ``perm`` is an integer tensor [B, 4]: ``perm[b, c]`` is the agent that
    stands in corner ``c`` of board ``b`` (corner order ``CORNER_X`` /
    ``CORNER_Y``).  Every row must be a permutation of 0-3.
    """
    dev = cs.board.device
    perm = perm.to(device=dev, dtype=torch.int64)
    b = perm.shape[0]
    cx = torch.tensor(CORNER_X, dtype=I32, device=dev).expand(b, -1)
    cy = torch.tensor(CORNER_Y, dtype=I32, device=dev).expand(b, -1)
    board = cs.board.clone()
    for c in range(AGENT_COUNT):
        board[:, CORNER_X[c] + BOARD_SIZE * CORNER_Y[c]] = \
            (C_AGENT0 + perm[:, c]).to(I32)
    return cs._replace(
        board=board,
        agent_x=cs.agent_x.scatter(1, perm, cx),
        agent_y=cs.agent_y.scatter(1, perm, cy),
    )


def random_cell_state(b: int, seed: int = 0, device=None,
                      generator: torch.Generator | None = None,
                      randomize_positions: bool = False):
    """Fresh plane-encoded states for ``b`` boards (agents in the corners).

    Randomness comes from ``generator`` when given, else from a new
    generator on ``device`` seeded with ``seed``.  ``randomize_positions``
    draws, per board, which agent sits in which corner (a uniform
    permutation from the generator; the reference ``MakeGame``'s optional
    shuffle); off, agent ``i`` sits in corner ``i``.
    """
    from ..engine.cellular import empty_cell_state

    if generator is None:
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
    board, hidden = random_board_fast(b, generator)
    cs = empty_cell_state(b, generator.device)._replace(
        board=board, hidden_pow=hidden
    )
    if randomize_positions:
        perm = torch.rand((b, AGENT_COUNT), generator=generator,
                          device=generator.device).argsort(1)
        return put_agents_in_corners_perm(cs, perm)
    return put_agents_in_corners(cs)

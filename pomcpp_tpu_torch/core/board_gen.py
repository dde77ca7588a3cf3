"""Batched random boards on a ``torch.Generator``.

Counterpart of ``random_board_fast`` / ``random_cell_state`` in
``pomcpp_tpu.core.board_gen``, with the same distribution (not the same
bits): each cell is rigid w.p. 1/7 and wood w.p. 1/7; each wood cell carries
a hidden powerup flag w.p. 1/2, drawn uniformly from [1, 4] (4 reads as
"empty wood" through ``& 0b11``); agents stand in the corners.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .constants import C_PASSAGE, C_RIGID, C_WOOD, NUM_CELLS
from .state import I32, put_agents_in_corners


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


def random_cell_state(b: int, seed: int = 0, device=None,
                      generator: torch.Generator | None = None):
    """Fresh plane-encoded states for ``b`` boards (agents in the corners).

    Randomness comes from ``generator`` when given, else from a new
    generator on ``device`` seeded with ``seed``.
    """
    from ..engine.cellular import empty_cell_state

    if generator is None:
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
    board, hidden = random_board_fast(b, generator)
    cs = empty_cell_state(b, generator.device)._replace(
        board=board, hidden_pow=hidden
    )
    return put_agents_in_corners(cs)

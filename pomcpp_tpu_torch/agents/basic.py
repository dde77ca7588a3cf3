"""Scripted baseline policies on an explicit ``torch.Generator``.

Counterpart of ``pomcpp_tpu.agents.basic``.  A policy here is the batched
form of the JAX one: ``policy(generator, game, agent_ids) -> moves`` with
``game`` a ``CellState`` of B boards, ``agent_ids`` an integer tensor [A]
and the result i32[B, A], drawn on the generator's device.  The JAX
policies draw from a key per board and agent; these draw one tensor from
the generator, with the same distribution and not the same bits.
"""

from __future__ import annotations

import torch

from ..core.state import I32


def _draw(generator: torch.Generator, game, agent_ids, n_moves: int):
    shape = (game.board.shape[0], len(agent_ids))
    return torch.randint(0, n_moves, shape, generator=generator,
                         device=generator.device, dtype=I32)


def lazy_agent(generator, game, agent_ids) -> torch.Tensor:
    """Always IDLE (reference LazyAgent)."""
    del generator
    return torch.zeros((game.board.shape[0], len(agent_ids)), dtype=I32,
                       device=game.board.device)


def random_agent(generator, game, agent_ids) -> torch.Tensor:
    """Uniform over all 6 moves, BOMB included (reference RandomAgent)."""
    return _draw(generator, game, agent_ids, 6)


def harmless_agent(generator, game, agent_ids) -> torch.Tensor:
    """Uniform over the 5 non-bomb moves (reference HarmlessAgent)."""
    return _draw(generator, game, agent_ids, 5)

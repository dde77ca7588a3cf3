"""Fog-of-war observations over batches of boards.

Counterpart of ``pomcpp_tpu.env.observation``.  Two forms:

* ``observe``     -- full-board planes; cells outside the view radius read
                     ``C_FOG`` on ``board`` and 0 on the other planes;
* ``observe_ego`` -- egocentric (2R+1) x (2R+1) crop; off-board cells read
                     ``C_RIGID`` on ``board`` and 0 on the other planes.

Both take the ``CellState`` of B boards.  ``agent_id`` is one agent (an
int; every leaf then has the leading axis B) or ``None`` for all four
agents at once (leading axes [B, 4]; ``teammate`` is then an int or four
ints).  The JAX ``observe_ego`` crops with one-hot products because gathers
serialise on a TPU; here the padded planes are read with one ``gather``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.constants import AGENT_COUNT, BOARD_SIZE, C_FOG, C_RIGID, NUM_CELLS
from ..core.state import I32
from ..engine.cellular import CellState

DEFAULT_VIEW_RANGE = 4  # classic Pommerman: a 9x9 window

_PLANES = ("board", "bomb_timer", "bomb_strength", "bomb_dir", "flame_timer")


class Observation(NamedTuple):
    """Per-agent view; planes are flat [121] (or [(2R+1)^2] for ego crops)
    behind the leading axes."""

    board: torch.Tensor        # item classes, C_FOG outside the view
    bomb_timer: torch.Tensor   # 0 outside the view
    bomb_strength: torch.Tensor
    bomb_dir: torch.Tensor
    flame_timer: torch.Tensor
    position: torch.Tensor     # i32[..., 2] own (x, y)
    max_bombs: torch.Tensor    # own stats (visible to self only)
    bomb_count: torch.Tensor
    strength: torch.Tensor
    can_kick: torch.Tensor
    alive: torch.Tensor        # bool[..., 4] public liveness
    teammate: torch.Tensor     # i32 teammate id or -1 (FFA)


def _view_mask(x, y, view_range: int):
    """bool[..., 121]: cells within ``view_range`` (Chebyshev) of (x, y)."""
    idx = torch.arange(NUM_CELLS, dtype=I32, device=x.device)
    cx, cy = idx % BOARD_SIZE, idx // BOARD_SIZE
    return ((cx - x[..., None]).abs() <= view_range) & \
        ((cy - y[..., None]).abs() <= view_range)


def _own(game: CellState, agent_id, teammate):
    """(select, x, y, stats) for one agent or for all four."""
    dev = game.board.device
    if agent_id is None:
        def sel(t):
            return t

        alive = (~game.agent_dead)[:, None, :].expand(-1, AGENT_COUNT, -1)
        shape = game.agent_x.shape
    else:
        def sel(t):
            return t[:, agent_id]

        alive = ~game.agent_dead
        shape = game.agent_x.shape[:1]
    if isinstance(teammate, int):       # no host-to-device copy
        mate = torch.full(shape, teammate, dtype=I32, device=dev)
    else:
        mate = torch.as_tensor(teammate, dtype=I32, device=dev).expand(shape)
    return sel, alive, mate


def _observation(game, sel, alive, mate, planes) -> Observation:
    x, y = sel(game.agent_x), sel(game.agent_y)
    return Observation(
        *planes,
        position=torch.stack([x, y], -1).to(I32),
        max_bombs=sel(game.agent_max_bombs),
        bomb_count=sel(game.agent_bomb_count),
        strength=sel(game.agent_strength),
        can_kick=sel(game.agent_can_kick),
        alive=alive,
        teammate=mate,
    )


def observe(game: CellState, agent_id=None,
            view_range: int = DEFAULT_VIEW_RANGE, teammate=-1) -> Observation:
    """Full-board fogged view."""
    sel, alive, mate = _own(game, agent_id, teammate)
    seen = _view_mask(sel(game.agent_x), sel(game.agent_y), view_range)

    def mask(name):
        p = getattr(game, name)
        if agent_id is None:
            p = p[:, None, :]
        return torch.where(seen, p, C_FOG if name == "board" else 0).to(I32)

    return _observation(game, sel, alive, mate, [mask(n) for n in _PLANES])


def observe_ego(game: CellState, agent_id=None,
                view_range: int = DEFAULT_VIEW_RANGE,
                teammate=-1) -> Observation:
    """Egocentric (2R+1) x (2R+1) crop; off-board cells read RIGID."""
    r = view_range
    w, pw = 2 * r + 1, BOARD_SIZE + 2 * r
    sel, alive, mate = _own(game, agent_id, teammate)
    x, y = sel(game.agent_x).long(), sel(game.agent_y).long()
    b, dev = game.board.shape[0], game.board.device
    # In padded coordinates the window of an agent at (x, y) starts at (x, y).
    d = torch.arange(w, device=dev)
    index = ((y[..., None, None] + d[:, None]) * pw
             + (x[..., None, None] + d[None, :])).reshape(x.shape + (w * w,))

    def crop(name):
        p = getattr(game, name).reshape(b, BOARD_SIZE, BOARD_SIZE)
        p = F.pad(p, (r, r, r, r), value=C_RIGID if name == "board" else 0)
        p = p.reshape(b, pw * pw)
        if agent_id is None:
            p = p[:, None, :].expand(-1, AGENT_COUNT, -1)
        return p.gather(-1, index).to(I32)

    return _observation(game, sel, alive, mate, [crop(n) for n in _PLANES])

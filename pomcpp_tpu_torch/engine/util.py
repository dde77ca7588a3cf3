"""Step helpers shared by the strategy code (``pomcpp_tpu.engine.util``).

Only ``desired_position`` is needed so far; it broadcasts over any leading
batch axes.
"""

from __future__ import annotations

import torch

from ..core.constants import MOVE_DX, MOVE_DY
from ..core.state import I32


def desired_position(x, y, move):
    """util::DesiredPosition (step_utility.cpp:9-31); IDLE/BOMB stay put.

    ``move`` holds move codes in [0, 6); ``x``, ``y`` and ``move``
    broadcast against each other.
    """
    move = torch.as_tensor(move)
    dx = torch.tensor(MOVE_DX, dtype=I32, device=move.device)
    dy = torch.tensor(MOVE_DY, dtype=I32, device=move.device)
    idx = move.long().clamp(0, len(MOVE_DX) - 1)
    return x + dx[idx], y + dy[idx]

"""Lossless conversion of game state between numpy and the port's tensors.

The system has no weights: the game state is what crosses between the JAX
package and the port.  ``to_torch`` takes any object with the ``CellState``
field names (a ``CellState`` of numpy arrays, or the JAX package's
``CellState`` -- anything ``numpy.asarray`` reads) and builds the port's
``CellState`` on a device; ``to_numpy`` goes back.  Integer fields are int32,
``agent_can_kick`` / ``agent_dead`` are bool, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .engine.cellular import CellState

BOOL_FIELDS = ("agent_can_kick", "agent_dead")


def to_torch(state, device=None) -> CellState:
    """Port ``CellState`` on ``device`` (None: CUDA) from array-likes."""
    device = resolve_device(device)
    out = {}
    for name in CellState._fields:
        a = np.asarray(getattr(state, name))
        a = a.astype(np.bool_ if name in BOOL_FIELDS else np.int32)
        out[name] = torch.from_numpy(a).to(device)
    return CellState(**out)


def to_numpy(cs: CellState) -> CellState:
    """``CellState`` of numpy arrays (same dtypes) from the port's tensors."""
    return CellState(*(t.detach().cpu().numpy() for t in cs))


def diff_fields(a, b, skip=("timestep",)) -> list[str]:
    """Names of the ``CellState`` fields that differ between two states.

    Either side may hold tensors (any device) or array-likes; equality is
    exact, as every field is an integer or bool."""
    bad = []
    for name in CellState._fields:
        if name in skip:
            continue
        x, y = getattr(a, name), getattr(b, name)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x, y):
            bad.append(name)
    return bad

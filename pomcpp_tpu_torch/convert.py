"""Lossless conversion of game state between numpy and the port's tensors.

The system has no weights: the game state is what crosses between the JAX
package and the port.  ``to_torch`` takes any object with the ``CellState``
field names (a ``CellState`` of numpy arrays, or the JAX package's
``CellState`` -- anything ``numpy.asarray`` reads) and builds the port's
``CellState`` on a device; ``to_numpy`` goes back.  Integer fields are int32,
``agent_can_kick`` / ``agent_dead`` are bool, as in the JAX package.

The SimpleAgent's FSM state is carried across too.  ``fsm_to_torch`` reads
the JAX package's ten-array kernel state (``simple_fsm_state_init``'s
layout); ``simple_state_to_fsm`` / ``fsm_to_simple_state`` map a
``SimpleAgentState`` onto that layout and back.  Logical ring slot ``j`` is
physical slot ``(head + j) % 4``, stored as ``(x + 1) + 13 * (y + 1)``; the
kernel layout's head is always 0.  The map is lossless: a state with head
``h`` comes back as the same ring rotated to head 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .agents.simple import FsmState, SimpleAgentState
from .core.state import I32
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


def fsm_to_torch(arrays, device=None) -> FsmState:
    """Port ``FsmState`` on ``device`` (None: CUDA) from ten array-likes."""
    device = resolve_device(device)
    return FsmState(*(
        torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)
        for a in arrays
    ))


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

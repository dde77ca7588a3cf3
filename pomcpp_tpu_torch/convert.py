"""Lossless conversion of state between numpy and the port's tensors.

Game state.  ``to_torch`` takes any object with the ``CellState``
field names (a ``CellState`` of numpy arrays, or the JAX package's
``CellState`` -- anything ``numpy.asarray`` reads) and builds the port's
``CellState`` on a device; ``to_numpy`` goes back.  Integer fields are int32,
``agent_can_kick`` / ``agent_dead`` are bool, as in the JAX package.
``state_to_torch`` does the same for the queue-encoded ``State`` of one
board.

The SimpleAgent's FSM state is carried across too.  ``fsm_to_torch`` reads
the JAX package's ten-array kernel state (``simple_fsm_state_init``'s
layout); ``simple_state_to_fsm`` / ``fsm_to_simple_state`` map a
``SimpleAgentState`` onto that layout and back.  Logical ring slot ``j`` is
physical slot ``(head + j) % 4``, stored as ``(x + 1) + 13 * (y + 1)``; the
kernel layout's head is always 0.  The map is lossless: a state with head
``h`` comes back as the same ring rotated to head 0.

Weights and training state.  ``params_from_jax`` / ``params_to_jax`` map
the JAX ``ActorCritic``'s flax parameters onto the port's ``state_dict``
and back (conv kernels HWIO <-> OIHW, dense kernels ``(in, out)`` <->
``(out, in)``), as numpy arrays.  ``train_state_leaves`` /
``load_train_state_leaves`` read and write a learner ``TrainState`` as the
33 leaves of the JAX ``TrainState`` in ``jax.tree.leaves`` order: the ten
params (per layer in flax order: bias, kernel), Adam's count, its ten
first and ten second moments, the key (u32[2]) and ``update_count``.  The
moments and the count go into ``torch.optim.Adam``'s ``exp_avg``,
``exp_avg_sq`` and ``step``, so that bias correction goes on where optax
stopped.
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


def state_to_torch(state, device=None):
    """Port queue-encoded ``State`` (one board) on ``device`` (None: CUDA)
    from array-likes with its field names, e.g. the JAX package's.  Bool
    fields stay bool; every other field becomes int32."""
    from .core.state import Bombs, Flames, State

    device = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        a = a if a.dtype == np.bool_ else a.astype(np.int32)
        return torch.from_numpy(np.array(a)).to(device)

    out = {f: tensor(getattr(state, f)) for f in State._fields
           if f not in ("bombs", "flames")}
    return State(bombs=Bombs(*map(tensor, state.bombs)),
                 flames=Flames(*map(tensor, state.flames)), **out)


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


# flax layer name -> the port's submodule, in the order of jax.tree.leaves.
FLAX_LAYERS = (("Conv_0", "convs.0"), ("Conv_1", "convs.1"),
               ("Dense_0", "dense"), ("Dense_1", "policy"),
               ("Dense_2", "value"))
N_TRAIN_STATE_LEAVES = 33


def _kernel_from_jax(k):
    k = np.asarray(k, np.float32)
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T


def _kernel_to_jax(w):
    w = np.asarray(w, np.float32)
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def params_from_jax(params) -> dict:
    """The port's ``state_dict`` (numpy f32) of flax ``ActorCritic`` params
    (``{"params": {...}}`` or the inner dict)."""
    p = params.get("params", params)
    out = {}
    for flax_name, name in FLAX_LAYERS:
        out[f"{name}.weight"] = np.array(
            _kernel_from_jax(p[flax_name]["kernel"]), order="C")
        out[f"{name}.bias"] = np.array(p[flax_name]["bias"], np.float32)
    return out


def params_to_jax(state_dict) -> dict:
    """flax ``{"params": {...}}`` (numpy f32) of the port's ``state_dict``
    (tensors or arrays)."""
    return {"params": {
        flax_name: {"bias": _leaf(state_dict[f"{name}.bias"]),
                    "kernel": _leaf(state_dict[f"{name}.weight"])}
        for flax_name, name in FLAX_LAYERS
    }}


def _flax_params(model):
    """The model's parameters in ``jax.tree.leaves`` order (per layer: bias,
    weight)."""
    mods = dict(model.named_modules())
    return [p for _, name in FLAX_LAYERS
            for p in (mods[name].bias, mods[name].weight)]


def _leaf(t) -> np.ndarray:
    """A parameter-shaped tensor (or array) as its JAX leaf."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(_kernel_to_jax(a)) if a.ndim > 1 else a


def train_state_leaves(ts) -> list:
    """The 33 leaves of the JAX ``TrainState`` for a learner ``TrainState``
    (``learner.ppo``): params, Adam count, mu, nu, key, update_count."""
    params = _flax_params(ts.model)
    state = [ts.optimizer.state.get(p, {}) for p in params]
    count = int(state[0]["step"]) if state[0] else 0
    mu = [_leaf(s["exp_avg"]) if s else np.zeros_like(_leaf(p))
          for p, s in zip(params, state)]
    nu = [_leaf(s["exp_avg_sq"]) if s else np.zeros_like(_leaf(p))
          for p, s in zip(params, state)]
    return ([_leaf(p) for p in params] + [np.asarray(count, np.int32)] + mu
            + nu + [np.asarray(ts.key, np.uint32).reshape(2),
                    np.asarray(ts.update_count, np.int32)])


def load_train_state_leaves(ts, leaves):
    """Write the 33 JAX ``TrainState`` leaves into ``ts`` (its model and
    optimizer, in place) and return it with the leaves' key and
    ``update_count``."""
    leaves = [np.asarray(a) for a in leaves]
    if len(leaves) != N_TRAIN_STATE_LEAVES:
        raise ValueError(f"a TrainState has {N_TRAIN_STATE_LEAVES} leaves, "
                         f"got {len(leaves)}")
    params = _flax_params(ts.model)

    def tensor(a, p):
        a = _kernel_from_jax(a) if a.ndim > 1 else a.astype(np.float32)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"leaf of shape {a.shape} for a parameter of "
                             f"shape {tuple(p.shape)}: wrong model?")
        return torch.from_numpy(np.ascontiguousarray(a)).to(p.device)

    count = int(leaves[10])
    with torch.no_grad():
        for i, p in enumerate(params):
            p.copy_(tensor(leaves[i], p))
            ts.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": tensor(leaves[11 + i], p),
                "exp_avg_sq": tensor(leaves[21 + i], p),
            }
    return ts._replace(key=leaves[31].astype(np.uint32).reshape(2),
                       update_count=int(leaves[32]))

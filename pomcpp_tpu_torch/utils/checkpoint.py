"""Checkpoints of a learner's training state, and the full resume bundle.

Weights.  ``save_checkpoint`` / ``restore_checkpoint`` are the counterpart
of ``pomcpp_tpu.utils.checkpoint`` with its npz backend: a directory
holding ``checkpoint.npz``, whose arrays ``leaf_0`` ... ``leaf_32`` are the
leaves of the JAX ``TrainState`` in ``jax.tree.leaves`` order
(``convert.train_state_leaves``).  So ``pomcpp_tpu.utils.restore_checkpoint``
reads what the port writes, and the port reads the JAX package's
checkpoints (``artifacts/ppo_*``).  The orbax backend has no counterpart.

The resume bundle.  ``save_bundle`` / ``restore_bundle`` hold everything a
killed run needs to go on as if it had not stopped: the 33 ``TrainState``
leaves, the states of the learner's generators (``TrainState.gen`` and
``host_gen``, one pair per rank; they draw the moves, the minibatch
permutations and the mixed-control seeds), the global ``EnvState``
(``key`` i64[B, 3] included), the opponent state (the ten FSM arrays or a
``SimpleAgentState``) and the iteration to start from.  It is the port's
own format, one ``bundle.npz`` of named arrays.  The JAX package's bundle
(``<ckpt_dir>/resume/checkpoint.npz``) holds a JAX PRNG key where the port
holds its reset stream, and no generator states, so neither package reads
the other's bundle; the weights-only ``checkpoint.npz`` stays readable by
both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import (
    N_TRAIN_STATE_LEAVES,
    load_train_state_leaves,
    train_state_leaves,
)

_NPZ = "checkpoint.npz"
_BUNDLE = "bundle.npz"
BUNDLE_FORMAT = "pomcpp_tpu_torch resume bundle 1"


def _write_npz(path: str, name: str, arrays: dict) -> None:
    """Write ``arrays`` as ``path/name`` by an atomic replace: an
    interrupted save must not truncate the only file a later --resume
    depends on."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(path: str, ts) -> None:
    """Write the learner state ``ts`` under directory ``path``."""
    _write_npz(path, _NPZ, {f"leaf_{i}": a for i, a in
                            enumerate(train_state_leaves(ts))})


def checkpoint_leaves(path: str) -> list:
    """The leaves of the checkpoint under directory ``path``, in order."""
    with np.load(os.path.join(os.path.abspath(path), _NPZ)) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def restore_checkpoint(path: str, ts):
    """Load the checkpoint under ``path`` into ``ts`` (its model and
    optimizer, in place) and return it with the stored key and
    ``update_count``."""
    return load_train_state_leaves(ts, checkpoint_leaves(path))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_bundle(path: str, ts, es, opp, it: int, gen_states=None) -> None:
    """Write the resume bundle under directory ``path``.

    ``es`` and ``opp`` are the GLOBAL env and opponent state (a
    data-parallel run gathers them first, ``parallel.gather_batch``);
    ``opp`` may be None (self-play).  ``it`` is the iteration the resumed
    run starts from.  ``gen_states`` lists each rank's ``(gen, host_gen)``
    states (uint8 tensors); None means ``ts``'s own, a run of one rank."""
    if gen_states is None:
        gen_states = [(ts.gen.get_state(), ts.host_gen.get_state())]
    arrays = {f"ts_{i}": a for i, a in enumerate(train_state_leaves(ts))}
    arrays.update({f"env_game_{k}": _host(v)
                   for k, v in es.game._asdict().items()})
    arrays.update({f"env_{k}": _host(v) for k, v in es._asdict().items()
                   if k != "game"})
    if opp is not None:
        arrays["opp_kind"] = np.array(type(opp).__name__)
        arrays.update({f"opp_{k}": _host(v)
                       for k, v in opp._asdict().items()})
    for r, (gen, host_gen) in enumerate(gen_states):
        arrays[f"gen_{r}"] = _host(gen)
        arrays[f"host_gen_{r}"] = _host(host_gen)
    arrays.update(format=np.array(BUNDLE_FORMAT), iter=np.array(it, np.int64),
                  world_size=np.array(len(gen_states), np.int64))
    _write_npz(path, _BUNDLE, arrays)


def restore_bundle(path: str, ts, device=None, rank: int = 0,
                   world_size: int = 1):
    """Read the resume bundle under ``path`` -> ``(ts, es, opp, it)``.

    The weights, the optimizer and rank ``rank``'s generator states go into
    ``ts`` (in place); ``es`` and ``opp`` are the GLOBAL states on
    ``device`` (None: the card), which a data-parallel run slices
    (``parallel.shard_batch``); ``opp`` is None for a self-play bundle.  A
    directory without this package's bundle, or a bundle written by
    another number of ranks, raises ``ValueError``."""
    from ..agents.simple import FsmState, SimpleAgentState
    from ..device import resolve_device
    from ..engine.cellular import CellState
    from ..env.environment import EnvState

    device = resolve_device(device)
    file = os.path.join(os.path.abspath(path), _BUNDLE)
    if not os.path.exists(file):
        raise ValueError(f"{path} holds no resume bundle of this package "
                         f"(the JAX package's bundle cannot be read)")
    with np.load(file) as data:
        d = {k: data[k] for k in data.files}
    if str(d.get("format")) != BUNDLE_FORMAT:
        raise ValueError(f"{path} holds no resume bundle of this package "
                         f"(format {d.get('format')!r})")
    wrote = int(d["world_size"])
    if wrote != world_size:
        raise ValueError(
            f"the bundle under {path} was written by {wrote} rank(s); this "
            f"run has {world_size}: resume with the same world size")

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device)

    ts = load_train_state_leaves(
        ts, [d[f"ts_{i}"] for i in range(N_TRAIN_STATE_LEAVES)])
    ts.gen.set_state(torch.from_numpy(d[f"gen_{rank}"]))
    ts.host_gen.set_state(torch.from_numpy(d[f"host_gen_{rank}"]))
    game = CellState(**{k: tensor(d[f"env_game_{k}"])
                        for k in CellState._fields})
    es = EnvState(game, **{k: tensor(d[f"env_{k}"])
                           for k in EnvState._fields if k != "game"})
    opp = None
    if "opp_kind" in d:
        kind = {"FsmState": FsmState,
                "SimpleAgentState": SimpleAgentState}[str(d["opp_kind"])]
        opp = kind(**{k: tensor(d[f"opp_{k}"]) for k in kind._fields})
    return ts, es, opp, int(d["iter"])

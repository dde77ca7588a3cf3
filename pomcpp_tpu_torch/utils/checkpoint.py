"""Checkpoints of a learner's training state, in the JAX package's format.

Counterpart of ``pomcpp_tpu.utils.checkpoint`` with its npz backend: a
directory holding ``checkpoint.npz``, whose arrays ``leaf_0`` ...
``leaf_32`` are the leaves of the JAX ``TrainState`` in ``jax.tree.leaves``
order (``convert.train_state_leaves``).  So
``pomcpp_tpu.utils.restore_checkpoint`` reads what the port writes, and the
port reads the JAX package's checkpoints (``artifacts/ppo_*``).  The orbax
backend has no counterpart.
"""

from __future__ import annotations

import os

import numpy as np

from ..convert import load_train_state_leaves, train_state_leaves

_NPZ = "checkpoint.npz"


def save_checkpoint(path: str, ts) -> None:
    """Write the learner state ``ts`` under directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves = train_state_leaves(ts)
    # Atomic replace: an interrupted save must not truncate the only
    # checkpoint a later --resume depends on.
    tmp = os.path.join(path, _NPZ + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    os.replace(tmp, os.path.join(path, _NPZ))


def checkpoint_leaves(path: str) -> list:
    """The leaves of the checkpoint under directory ``path``, in order."""
    with np.load(os.path.join(os.path.abspath(path), _NPZ)) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def restore_checkpoint(path: str, ts):
    """Load the checkpoint under ``path`` into ``ts`` (its model and
    optimizer, in place) and return it with the stored key and
    ``update_count``."""
    return load_train_state_leaves(ts, checkpoint_leaves(path))

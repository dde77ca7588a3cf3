"""Data parallelism over the board batch with ``torch.distributed``.

Counterpart of ``pomcpp_tpu.parallel.mesh``.  The one scale-out axis is the
boards axis: rank ``r`` of ``W`` holds rows ``[r * B/W, (r + 1) * B/W)`` of
every batched state (what ``NamedSharding`` does on a 1-D mesh), steps
them on its own device, and talks to the other ranks only for the
learner's statistics, its gradients and its metrics (``all_reduce``), and
for gathers of the global state (a resume bundle, tests).

* ``boards_mesh``      -- join the process group -> a ``BoardsMesh``
* ``shard_batch``      -- this rank's rows of any batched (nested) tuple
* ``shard_env_batch``  -- the same for an ``EnvState``
* ``gather_batch``     -- the global rows back, on every rank
* ``sharded_rollout``  -- the env rollout of a rank's rows
* ``sharded_chunk_rollout`` -- the chunk kernel on a rank's rows

Reset stream.  The env resets a board from its key row, which holds the
board's GLOBAL id (``env_reset`` writes it), so a rank's rows reset as the
same rows of the unsharded batch do: build the global batch and slice it.

Draws.  The chunk kernel draws from its local board index, and a learner's
generators are per rank; both fold the rank into their seed as the JAX
package does (``fold_seed``: ``seed + rank * 1_000_003``) so that ranks do
not draw the same numbers.  The model's weights come from the unfolded
seed, so every rank starts from the same net.

Backends.  NCCL when each rank has a card of its own, gloo on the CPU.
NCCL refuses two ranks on one card, so the backend is an argument: two
gloo ranks may share a card.  Collectives on CUDA tensors are kept to
``all_reduce`` and ``broadcast``, which gloo runs on them; a gather goes
through the host under gloo.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..engine.fused_step import rollout_chunk
from ..env.environment import EnvState, rollout

FOLD = 1_000_003


class BoardsMesh(NamedTuple):
    """This process's place in the 1-D boards mesh."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def fold_seed(seed: int, rank: int) -> int:
    """A rank's seed for its own draws (``mesh.py:120-122`` of the JAX
    package)."""
    return seed + rank * FOLD


def boards_mesh(backend: str | None = None, device=None,
                init_method: str | None = None, rank: int | None = None,
                world_size: int | None = None) -> BoardsMesh:
    """Join the default process group (starting it if it is not) and
    return this rank's ``BoardsMesh``.

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` as
    ``python -m torch.distributed.run`` sets them, and ``init_method`` to
    ``env://`` (its ``MASTER_ADDR`` / ``MASTER_PORT``).  ``device`` None
    means card ``LOCAL_RANK``; ``backend`` None means NCCL on a card and
    gloo on the CPU."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) \
        if world_size is None else world_size
    device = resolve_device(
        f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}" if device is None
        else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(
            f"the process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, asked for {rank} of {world_size}")
    return BoardsMesh(rank, world_size, device, dist.get_backend())


def local_rows(b: int, mesh: BoardsMesh) -> slice:
    """This rank's rows of a global batch of ``b``."""
    if b % mesh.world_size:
        raise ValueError(f"a batch of {b} does not divide over "
                         f"{mesh.world_size} ranks")
    n = b // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _map(fn, tree):
    """``fn`` over the tensors of a (nested, named) tuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    out = [_map(fn, t) for t in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def shard_batch(tree, mesh: BoardsMesh, axis: int = 0):
    """This rank's rows (along ``axis``) of every tensor of a batched
    (nested) tuple, on the rank's device."""
    def take(t):
        rows = local_rows(t.shape[axis], mesh)
        return t.narrow(axis, rows.start, rows.stop - rows.start) \
            .to(mesh.device).contiguous()

    return _map(take, tree)


def shard_env_batch(es: EnvState, mesh: BoardsMesh) -> EnvState:
    """This rank's boards of a global ``EnvState``."""
    return shard_batch(es, mesh)


def gather_batch(tree, mesh: BoardsMesh, axis: int = 0):
    """The global batch from every rank's rows (along ``axis``), on every
    rank, on the device the rows are on.  Under gloo the rows travel
    through the host."""
    def gather(t):
        host = mesh.backend == "gloo"
        x = t.detach()
        x = (x.to(torch.uint8) if x.dtype == torch.bool else x)
        x = (x.cpu() if host else x.to(mesh.device)).contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x)
        out = torch.cat(parts, axis).to(t.device)
        return out.bool() if t.dtype == torch.bool else out

    return _map(gather, tree)


def all_reduce_sum(t: torch.Tensor, mesh: BoardsMesh | None) -> torch.Tensor:
    """``t`` summed over the ranks, in place (no-op without a mesh)."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def sharded_rollout(mesh: BoardsMesh, policy, n_steps: int,
                    auto_reset: bool = True, team_mode: bool = False,
                    max_steps: int = 0):
    """``run(es, generator=None) -> (final_es, metrics)``: ``env.rollout``
    of this rank's boards (``shard_env_batch``) on its device.  Boards are
    independent, so the rollout needs no collective; reductions belong to
    the caller."""
    def run(es: EnvState, generator=None):
        return rollout(es, policy, n_steps, auto_reset=auto_reset,
                       team_mode=team_mode, max_steps=max_steps,
                       generator=generator, device=mesh.device)

    return run


def sharded_chunk_rollout(mesh: BoardsMesh, steps: int = 64,
                          policy: str = "random", *, record: bool = False,
                          auto_reset: bool = True, inject_slots: tuple = (),
                          prng_rand: bool = False):
    """``run(cs, seed, fsm_state=None, moves=None, reset_boards=None)``:
    ``rollout_chunk`` of this rank's boards on its device, with the rank
    folded into ``seed``.  ``cs`` and ``fsm_state`` are the rank's rows,
    ``moves`` its rows of i32[steps, B, 4] (axis 1, ``shard_batch(...,
    axis=1)``), ``reset_boards`` its rows of the fresh terrain.  Outputs
    are as ``rollout_chunk``'s, for the rank's rows."""
    def run(cs, seed: int, fsm_state=None, moves=None, reset_boards=None):
        return rollout_chunk(
            cs, fold_seed(seed, mesh.rank), steps, policy, moves=moves,
            record=record, auto_reset=auto_reset, reset_boards=reset_boards,
            device=mesh.device, fsm_state=fsm_state,
            inject_slots=tuple(inject_slots), prng_rand=prng_rand)

    return run

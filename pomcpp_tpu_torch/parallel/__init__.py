"""Data parallelism over the board batch (``torch.distributed``)."""

from .mesh import (
    BoardsMesh,
    all_reduce_sum,
    boards_mesh,
    fold_seed,
    gather_batch,
    local_rows,
    shard_batch,
    shard_env_batch,
    sharded_chunk_rollout,
    sharded_rollout,
)

__all__ = ["BoardsMesh", "all_reduce_sum", "boards_mesh", "fold_seed",
           "gather_batch", "local_rows", "shard_batch", "shard_env_batch",
           "sharded_chunk_rollout", "sharded_rollout"]

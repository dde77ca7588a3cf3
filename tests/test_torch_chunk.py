"""Port ``rollout_chunk_plain`` vs ``pallas_rollout_chunk(interpret=True)``.

The TPU kernel's in-kernel PRNG does not run off the TPU, so the JAX side
takes its moves and fresh terrain through the injection hooks (``moves=``,
``reset_boards=``) and records what it did (``record=True``); the port gets
the same inputs.  Tolerance: exact equality of every CellState field,
``timestep`` and ``alive_count`` included, and of the recorded moves and
done masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import random_cell_state
from pomcpp_tpu.core.constants import C_FLAME
from pomcpp_tpu.engine.pallas_step import pallas_rollout_chunk
from pomcpp_tpu_torch.convert import diff_fields, to_torch
from pomcpp_tpu_torch.engine.fused_step import (
    philox4x32,
    rollout_chunk,
    rollout_chunk_plain,
)


def _batch(seed, b):
    csb = jax.vmap(random_cell_state)(jax.random.split(jax.random.PRNGKey(seed), b))
    return jax.tree.map(np.asarray, csb)


def _compare(ref, got):
    ref_cs, ref_m, ref_d = ref
    got_cs, got_m, got_d = got
    bad = diff_fields(ref_cs, got_cs, skip=())
    assert not bad, f"fields differ: {bad}"
    assert np.array_equal(np.asarray(ref_m), got_m.numpy())
    assert np.array_equal(np.asarray(ref_d), got_d.numpy())


def test_chunk_without_reset_matches_pallas():
    steps, b = 20, 8
    cs = _batch(42, b)
    cs = cs._replace(
        agent_can_kick=np.zeros((b, 4), bool), timestep=np.full((b,), 7, np.int32)
    )
    cs.agent_can_kick[:2] = True
    moves = np.random.RandomState(7).randint(0, 6, size=(steps, b, 4)).astype(np.int32)
    ref = pallas_rollout_chunk(
        jax.tree.map(jnp.asarray, cs), 0, steps=steps, interpret=True,
        moves=jnp.asarray(moves), auto_reset=False, record=True,
    )
    got = rollout_chunk_plain(
        to_torch(cs, "cpu"), 0, steps, "random", moves=torch.from_numpy(moves),
        record=True, auto_reset=False,
    )
    _compare(ref, got)


def _reset_heavy_batch(b):
    """Boards 0-1 finished at entry; boards 4-7 have two agents left on a
    board of flames, so a random walker soon dies and the board resets
    mid-chunk; boards 8-9 have kick."""
    cs = _batch(9, b)
    dead = np.zeros((b, 4), bool)
    dead[0:2, 1:] = True
    dead[4:8, 2:] = True
    board, ftimer = cs.board.copy(), cs.flame_timer.copy()
    for k in range(4, 8):
        free = board[k] < 10
        board[k][free] = C_FLAME
        ftimer[k][free] = 4
    kick = np.zeros((b, 4), bool)
    kick[8:10] = True
    return cs._replace(
        board=board, flame_timer=ftimer, agent_dead=dead, agent_can_kick=kick,
        alive_count=(4 - dead.sum(1)).astype(np.int32),
        timestep=np.arange(b, dtype=np.int32),
    )


@pytest.mark.parametrize("policy,n_moves", [("harmless", 5), ("random", 6)])
def test_chunk_with_reset_matches_pallas(policy, n_moves):
    steps, b = 30, 16
    cs = _reset_heavy_batch(b)
    fresh = _batch(123, b)
    reset = (fresh.board, fresh.hidden_pow)
    rng = np.random.RandomState(n_moves)
    moves = rng.randint(0, n_moves, size=(steps, b, 4)).astype(np.int32)
    ref = pallas_rollout_chunk(
        jax.tree.map(jnp.asarray, cs), 0, steps=steps, interpret=True,
        policy=policy, moves=jnp.asarray(moves), record=True,
        reset_boards=tuple(map(jnp.asarray, reset)),
    )
    got = rollout_chunk(
        to_torch(cs, "cpu"), 0, steps, policy, moves=torch.from_numpy(moves),
        record=True, reset_boards=tuple(map(torch.tensor, reset)),
        device="cpu",
    )
    _compare(ref, got)
    done = got[2].numpy()
    # Boards finished at entry reset at step 0; some others finish mid-chunk.
    assert not done[0, 0:2].any()
    assert done[1:, 4:8].any()


def test_philox_known_answers():
    """Random123's philox4x32_10 known-answer vectors."""
    cases = [
        ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, 0xFFFFFFFF_FFFFFFFF,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         0x299F31D0_A4093822,
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, seed, want in cases:
        got = tuple(int(w) for w in philox4x32(*ctr, seed))
        assert got == want


@pytest.mark.parametrize("policy,n_moves", [("harmless", 5), ("random", 6)])
def test_in_kernel_draws_and_auto_reset(policy, n_moves):
    """Philox draws lie in [0, n_moves) and are close to uniform; the run
    keeps the state invariants through auto-resets."""
    from pomcpp_tpu_torch.core.board_gen import random_cell_state as port_boards

    b, steps = 64, 40
    cs = port_boards(b, seed=1, device="cpu")
    out, mv, _ = rollout_chunk(cs, 17, steps, policy, record=True, device="cpu")
    mv = mv.numpy()
    assert mv.min() == 0 and mv.max() == n_moves - 1
    counts = np.bincount(mv.ravel(), minlength=n_moves)
    n = mv.size
    p = 1.0 / n_moves
    # 5 sigma of the binomial count per move.
    assert np.all(np.abs(counts - n * p) < 5 * np.sqrt(n * p * (1 - p)))
    assert (out.timestep == steps).all()
    assert (out.alive_count == 4 - out.agent_dead.sum(1)).all()
    assert (out.alive_count >= 2).all()  # finished boards were reset
    # Same seed, same chunk: the plain version is deterministic.
    again = rollout_chunk(cs, 17, steps, policy, device="cpu")
    assert not diff_fields(out, again, skip=())

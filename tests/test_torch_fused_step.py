"""Port ``fused_step_plain`` vs ``pallas_step(interpret=True)`` on the CPU.

Tolerance: exact equality of every CellState field (all state is integer
or bool); ``timestep`` is kept by both and compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import init_state_np
from pomcpp_tpu.core.constants import C_FLAME
from pomcpp_tpu.core.state import empty_state, plant_bomb, put_agent
from pomcpp_tpu.engine.cellular import from_state
from pomcpp_tpu.engine.pallas_step import pallas_step
from pomcpp_tpu_torch.convert import diff_fields, to_torch
from pomcpp_tpu_torch.engine.fused_step import (
    MAX_CHAIN_ROUNDS,
    fused_step,
    fused_step_plain,
)


def _stack(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


@pytest.mark.parametrize("seed", [1, 2])
def test_trajectory_matches_pallas_step(seed):
    """30 random steps on four boards, two of them with kick."""
    b, steps = 4, 30
    csb = _stack([from_state(init_state_np(seed * 10 + k)) for k in range(b)])
    csb = csb._replace(agent_can_kick=jnp.zeros((b, 4), bool).at[:2].set(True))
    rng = np.random.RandomState(seed)
    got = to_torch(csb, "cpu")
    for t in range(steps):
        mv = rng.randint(0, 6, size=(b, 4)).astype(np.int32)
        csb = pallas_step(csb, jnp.asarray(mv), interpret=True)
        got = fused_step_plain(got, torch.from_numpy(mv))
        bad = diff_fields(csb, got, skip=())
        assert not bad, f"seed {seed} step {t}: fields differ: {bad}"


def _six_bomb_chain():
    """Six bombs in a row on y=0; bomb 0 fires next step, the rest are far
    from their own timers (tests/test_pallas_step.py's chain-cap case)."""
    s = empty_state()
    s = put_agent(s, 10, 10, 0)
    s = put_agent(s, 10, 9, 1)
    s = put_agent(s, 9, 10, 2)
    s = put_agent(s, 9, 9, 3)
    s = s._replace(agent_max_bombs=jnp.full((4,), 8, jnp.int32))
    s = plant_bomb(s, 0, 0, 0, set_item=True, life=1)
    for k in range(1, 6):
        s = plant_bomb(s, k, 0, (k % 4), set_item=True, life=9)
    return jax.tree.map(lambda x: jnp.stack([x]), from_state(s))


def test_chain_cap_matches_pallas_step():
    assert MAX_CHAIN_ROUNDS == 4
    csb = _six_bomb_chain()
    mv = np.zeros((1, 4), np.int32)
    ref = pallas_step(csb, jnp.asarray(mv), interpret=True)
    got = fused_step(to_torch(csb, "cpu"), torch.from_numpy(mv), device="cpu")
    assert not diff_fields(ref, got, skip=())
    bt = got.bomb_timer[0].numpy()
    board = got.board[0].numpy()
    # Bombs 0..3 exploded in the 4 rounds; cells 0..4 burn.
    assert (bt[[0, 1, 2, 3]] == 0).all()
    assert (board[[0, 1, 2, 3, 4]] == C_FLAME).all()
    # Bombs 4 and 5 survive with ticked timers and explode later.
    assert bt[4] == 8 and bt[5] == 8
    for _ in range(8):
        ref = pallas_step(ref, jnp.asarray(mv), interpret=True)
        got = fused_step(got, torch.from_numpy(mv), device="cpu")
        assert not diff_fields(ref, got, skip=())
    assert got.bomb_timer[0, 4] == 0 and got.bomb_timer[0, 5] == 0

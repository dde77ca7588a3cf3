"""Port ``cellular_step`` vs ``jax.vmap(cellular_step)`` on the CPU.

Tolerance: exact equality of every CellState field (all state is integer
or bool); ``timestep`` is left untouched by both and is compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import init_state_np, random_cell_state
from pomcpp_tpu.core.state import empty_state, plant_bomb, put_agent
from pomcpp_tpu.engine.cellular import cellular_step as jax_cellular_step
from pomcpp_tpu.engine.cellular import from_state
from pomcpp_tpu_torch.convert import diff_fields, to_torch
from pomcpp_tpu_torch.engine.cellular import cellular_step

_jstep = jax.jit(jax.vmap(jax_cellular_step))


def _stack(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _run_both(csb, moves_seq):
    """Step the JAX and the port engines side by side; fail on any diff."""
    got = to_torch(csb, "cpu")
    for t, mv in enumerate(moves_seq):
        csb = _jstep(csb, jnp.asarray(mv))
        got = cellular_step(got, torch.from_numpy(mv))
        bad = diff_fields(csb, got, skip=())
        assert not bad, f"step {t}: fields differ: {bad}"
    return csb


@pytest.mark.parametrize("kick", [False, True])
def test_trajectory_matches_jax(kick):
    """60 random steps on four reference-seeded boards."""
    b, steps = 4, 60
    csb = _stack([from_state(init_state_np(seed)) for seed in range(1, b + 1)])
    if kick:
        csb = csb._replace(agent_can_kick=jnp.ones((b, 4), bool))
    rng = np.random.RandomState(11 + kick)
    moves = rng.randint(0, 6, size=(steps, b, 4)).astype(np.int32)
    out = _run_both(csb, moves)
    # The trajectories must have exercised bombs and deaths.
    assert int(np.asarray(out.agent_dead).sum()) > 0


def test_random_cell_state_batch_matches_jax():
    """16 generated boards, half with kick, 40 random steps."""
    b, steps = 16, 40
    csb = jax.vmap(random_cell_state)(jax.random.split(jax.random.PRNGKey(5), b))
    csb = csb._replace(agent_can_kick=jnp.zeros((b, 4), bool).at[::2].set(True))
    rng = np.random.RandomState(3)
    moves = rng.randint(0, 6, size=(steps, b, 4)).astype(np.int32)
    _run_both(csb, moves)


def _kick_heavy_state():
    """Cross of kick-enabled agents around two bombs (every joint move
    exercises kick / block / reversion combinations)."""
    s = empty_state()
    s = put_agent(s, 4, 5, 0)
    s = put_agent(s, 6, 5, 1)
    s = put_agent(s, 5, 4, 2)
    s = put_agent(s, 5, 6, 3)
    s = s._replace(agent_can_kick=jnp.ones((4,), bool))
    s = plant_bomb(s, 5, 5, 0, set_item=True, life=6)
    s = plant_bomb(s, 3, 5, 1, set_item=True, life=9)
    return from_state(s)


def test_exhaustive_joint_moves_match_jax():
    """All 6^4 joint moves on the kick-heavy state, two steps deep."""
    n = 6 ** 4
    moves = np.stack(
        [[(c // 6 ** i) % 6 for i in range(4)] for c in range(n)]
    ).astype(np.int32)
    cs = _kick_heavy_state()
    csb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), cs)
    # The second step replays the same joint move from each resulting state.
    _run_both(csb, [moves, moves])

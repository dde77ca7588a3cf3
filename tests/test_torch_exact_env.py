"""The port's env layer over exact games vs ``pomcpp_tpu.env.environment``
on the CPU.

Exact games are queue-encoded ``State``s stepped by the exact conformance
engine.  The JAX side's fresh games are computed from its keys
(``_fresh(key, "exact")``) and injected into the port through ``fresh=``.
Tolerance: exact equality of every ``State`` field (every physical queue
slot) and of ``done`` / ``winner`` / ``is_draw`` after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import init_state_np
from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu_torch.agents.basic import random_agent
from pomcpp_tpu_torch.agents.simple import (
    simple_agent_init_batch,
    simple_agent_joint,
)
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.core.board_gen import random_board
from pomcpp_tpu_torch.core.state import State
from pomcpp_tpu_torch.env import environment as tenv
from pomcpp_tpu_torch.env.environment import EnvState

from test_torch_exact_step import assert_same

B, STEPS, MAX_STEPS = 32, 64, 24


def test_env_reset_np_matches_jax():
    for seed in (0, 7, 0x1337):
        ref = jenv.env_reset_np(seed)
        got = tenv.env_reset_np(seed, device="cpu")
        assert_same(jax.tree.map(lambda x: jnp.asarray(x)[None], ref.game),
                    got.game, f"seed {seed}")
        assert got.done.tolist() == [False] and got.winner.tolist() == [-1]
        assert got.is_draw.tolist() == [False]
        assert got.key.tolist() == [[seed, 0, 0]]


def _start():
    """Reference boards; board 0 done at entry (resets on the first step),
    boards 1-2 with one agent left and board 3 with none (they finish on
    the first step), half with kick."""
    game = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[init_state_np(s) for s in range(B)])
    dead = np.zeros((B, 4), bool)
    dead[1, 1:] = dead[2, [0, 1, 3]] = dead[3, :] = True
    kick = np.arange(B) % 2 == 1
    game = game._replace(
        agent_dead=jnp.asarray(dead),
        alive_count=jnp.asarray(4 - dead.sum(1), jnp.int32),
        agent_can_kick=jnp.asarray(np.repeat(kick[:, None], 4, 1)))
    done = np.zeros(B, bool)
    done[0] = True
    es_j = jenv.EnvState(game=game, done=jnp.asarray(done),
                         winner=jnp.full((B,), -1, jnp.int32),
                         is_draw=jnp.zeros((B,), bool),
                         key=jax.random.split(jax.random.PRNGKey(3), B))
    es_t = EnvState(state_to_torch(game, "cpu"), torch.from_numpy(done),
                    torch.full((B,), -1, dtype=torch.int32),
                    torch.zeros(B, dtype=torch.bool),
                    tenv.env_reset(3, B, engine="exact", device="cpu").key)
    return es_j, es_t


def _assert_env_same(es_j, es_t, what):
    assert_same(es_j.game, es_t.game, what)
    for name in ("done", "winner", "is_draw"):
        assert np.array_equal(np.asarray(getattr(es_j, name)),
                              getattr(es_t, name).numpy()), f"{what}: {name}"


@pytest.mark.parametrize("team_mode", [False, True])
def test_env_step_auto_reset_over_exact_games_matches_jax(team_mode):
    """64 steps of ``env_step_auto_reset`` with wins, draws at the step cap
    and resets; the JAX reset boards injected with ``fresh=``."""
    step_j = jax.jit(jax.vmap(lambda e, m: jenv.env_step_auto_reset(
        e, m, team_mode, MAX_STEPS)))
    fresh_j = jax.jit(jax.vmap(lambda k: jenv._fresh(k, "exact").game))
    es_j, es_t = _start()
    moves = np.random.default_rng(11).integers(0, 6, (STEPS, B, 4))
    resets = 0
    for t in range(STEPS):
        mv = moves[t].astype(np.int32)
        fresh = state_to_torch(fresh_j(es_j.key), "cpu")
        resets += int(np.asarray(es_j.done).sum())
        es_j = step_j(es_j, jnp.asarray(mv))
        es_t = tenv.env_step_auto_reset(
            es_t, torch.from_numpy(mv), team_mode=team_mode,
            max_steps=MAX_STEPS, fresh=fresh, device="cpu")
        _assert_env_same(es_j, es_t, f"step {t}")
    assert resets >= B // 2


def test_exact_reset_and_rollout_run_on_the_exact_engine():
    """``env_reset(engine="exact")`` draws exact games (exactly
    ceil(n_wood / 2) flagged wood cells); ``rollout`` steps them with the
    port's own resets; ``env_step`` freezes a finished exact game."""
    es = tenv.env_reset(5, 16, engine="exact", device="cpu")
    assert isinstance(es.game, State)
    board, hidden = random_board(es.key - torch.tensor([0, 0, 1]))
    wood = board == 2
    assert torch.equal(hidden > 0, wood & (hidden > 0))
    assert torch.equal((hidden > 0).sum(1), (wood.sum(1) + 1) // 2)
    assert torch.equal(es.game.hidden_pow, hidden)
    gen = torch.Generator().manual_seed(0)
    out, metrics = tenv.rollout(es, random_agent, 40, max_steps=12,
                                generator=gen, device="cpu")
    assert isinstance(out.game, State)
    assert metrics["done"].shape == (40, 16) and metrics["done"].any()
    assert (out.game.timestep <= 12).all()
    done = out._replace(done=torch.ones(16, dtype=torch.bool))
    frozen = tenv.env_step(done, torch.zeros((16, 4), dtype=torch.int32),
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(frozen.game), jax.tree.leaves(done.game)))
    with pytest.raises(ValueError, match="CellState"):
        tenv.env_step_auto_reset_batch(es, torch.zeros((16, 4)), fused=True,
                                       device="cpu")


def test_rollout_stateful_plays_the_exact_simple_agent():
    """``rollout_stateful(joint=True)`` with the exact SimpleAgent on exact
    games: its state is reset with the boards that restart."""
    es = tenv.env_reset(6, 8, engine="exact", device="cpu")
    gen = torch.Generator().manual_seed(1)

    def act(g, game, ps):
        rands = torch.randint(0, 5, (8, 4), generator=g, dtype=torch.int32)
        moves, _, ps2 = simple_agent_joint(game, ps, rands)
        return moves, ps2

    init = simple_agent_init_batch(8, "cpu")
    out, ps, metrics = tenv.rollout_stateful(
        es, act, init, 12, reset_policy_state=init, joint=True, max_steps=6,
        generator=gen, device="cpu")
    assert isinstance(out.game, State) and metrics["done"][5].all()
    # Done on step 6, fresh on step 7 (policy state reset), stepped 8-12:
    # five acts and five steps since.
    assert ps.rp_count.tolist() == [[4] * 4] * 8
    assert (out.game.timestep == 5).all()

"""The port's observations vs ``pomcpp_tpu.env.observation`` on the CPU.

Boards come from a numpy seed with every plane filled, agents placed in
corners, on edges and mid-board.  Tolerance: exact equality of every
``Observation`` field (all integers and bools).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.engine.cellular import CellState as JaxCellState
from pomcpp_tpu.env import observation as jobs
from pomcpp_tpu_torch.convert import to_torch
from pomcpp_tpu_torch.env import observation as tobs

# Per board: the four agents' (x, y).
PLACES = [
    [(0, 0), (10, 0), (10, 10), (0, 10)],      # corners
    [(5, 0), (10, 5), (5, 10), (0, 5)],        # edge midpoints
    [(5, 5), (4, 6), (2, 3), (8, 7)],          # mid-board
    [(1, 9), (9, 1), (3, 0), (10, 8)],         # near the border
    [(0, 1), (1, 0), (9, 10), (10, 9)],
]


def _boards(seed):
    rng = np.random.RandomState(seed)
    b = len(PLACES)
    plane = lambda hi: rng.randint(0, hi, size=(b, 121)).astype(np.int32)
    xy = np.array(PLACES, np.int32)
    return JaxCellState(
        board=plane(14), hidden_pow=plane(5), flame_timer=plane(5),
        bomb_timer=plane(11), bomb_strength=plane(6), bomb_dir=plane(5),
        bomb_owner=plane(4), agent_x=xy[:, :, 0], agent_y=xy[:, :, 1],
        agent_bomb_count=rng.randint(0, 3, size=(b, 4)).astype(np.int32),
        agent_max_bombs=rng.randint(1, 5, size=(b, 4)).astype(np.int32),
        agent_strength=rng.randint(1, 6, size=(b, 4)).astype(np.int32),
        agent_can_kick=rng.rand(b, 4) < 0.5,
        agent_dead=rng.rand(b, 4) < 0.3,
        alive_count=np.full(b, 4, np.int32),
        timestep=rng.randint(0, 800, size=b).astype(np.int32),
    )


def _same(ref, got, where):
    for name in jobs.Observation._fields:
        a, c = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == c.shape, f"{where}: {name} shape {a.shape} vs {c.shape}"
        assert a.dtype == c.dtype, f"{where}: {name} dtype {a.dtype} vs {c.dtype}"
        assert np.array_equal(a, c), f"{where}: {name}"


@pytest.mark.parametrize("view_range", [2, 4])
@pytest.mark.parametrize("form", ["observe", "observe_ego"])
def test_observation_matches_jax_for_every_agent(form, view_range):
    cs = _boards(view_range)
    game_j = jax.tree.map(jnp.asarray, cs)
    game_t = to_torch(cs, "cpu")
    fn_j, fn_t = getattr(jobs, form), getattr(tobs, form)
    for aid in range(4):
        mate = (aid + 2) % 4
        ref = jax.vmap(lambda g: fn_j(g, aid, view_range, mate))(game_j)
        _same(ref, fn_t(game_t, aid, view_range, mate), f"agent {aid}")
    # All four agents in one call: leading axes [B, 4].
    ref = jax.vmap(lambda g: jax.vmap(
        lambda a: fn_j(g, a, view_range, -1))(jnp.arange(4)))(game_j)
    _same(ref, fn_t(game_t, None, view_range), "all agents")


def test_ego_border_and_fog_fill():
    cs = _boards(0)
    game = to_torch(cs, "cpu")
    ego = tobs.observe_ego(game, 0, 2)            # board 0: agent at (0, 0)
    crop = ego.board[0].reshape(5, 5)
    assert (crop[:2] == 1).all() and (crop[:, :2] == 1).all()   # RIGID
    assert torch.equal(crop[2:, 2:].reshape(-1),
                       game.board[0].reshape(11, 11)[:3, :3].reshape(-1))
    assert (ego.bomb_timer[0].reshape(5, 5)[:2] == 0).all()
    fog = tobs.observe(game, 0, 2)
    seen = tobs._view_mask(game.agent_x[:, 0], game.agent_y[:, 0], 2)
    assert seen[0].sum() == 9 and seen[2].sum() == 25
    assert (fog.board[~seen] == 5).all() and (fog.flame_timer[~seen] == 0).all()
    assert torch.equal(fog.board[seen], game.board[seen])

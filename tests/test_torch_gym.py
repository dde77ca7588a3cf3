"""The port's gym front end vs ``pomcpp_tpu.env.gym_adapter`` on the CPU.

``_obs_planes`` is held key by key, exactly, against the vmapped JAX
function for the three fogs with and without the classic encoding; the
rewards and ``terminated`` / ``truncated`` are checked on scripted games
(rewards are 0 / +1 / -1 floats, exact); ``render()`` equals the JAX
renderer's drawing of the same board.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.env import gym_adapter as jgym
from pomcpp_tpu_torch.convert import to_torch
from pomcpp_tpu_torch.core.constants import C_AGENT0, C_PASSAGE
from pomcpp_tpu_torch.engine.cellular import empty_cell_state
from pomcpp_tpu_torch.env import gym_adapter as tgym
from pomcpp_tpu_torch.env.environment import _fresh, env_reset
from test_torch_observation import _boards


@pytest.mark.parametrize("classic", [False, True])
@pytest.mark.parametrize("team_mode", [False, True])
@pytest.mark.parametrize("fog", ["none", "fog", "ego"])
def test_obs_planes_match_jax(fog, team_mode, classic):
    cs = _boards(17)
    ref = jax.vmap(lambda g: jgym._obs_planes(g, fog, 3, team_mode, classic))(
        jax.tree.map(jnp.asarray, cs))
    got = tgym._obs_planes(to_torch(cs, "cpu"), fog, 3, team_mode, classic)
    assert len(ref) == len(got) == 4
    for aid, (r, g) in enumerate(zip(ref, got)):
        assert set(r) == set(g), f"agent {aid}: keys"
        for k in r:
            a, c = np.asarray(r[k]), g[k].numpy()
            assert a.shape == c.shape and a.dtype == c.dtype, (aid, k)
            assert np.array_equal(a, c), f"agent {aid}: {k}"


def test_classic_tables_are_the_jax_package_s():
    assert tgym.CLASSIC_ITEM_TABLE == jgym.CLASSIC_ITEM_TABLE
    assert tgym.CLASSIC_ACTION_TABLE == jgym.CLASSIC_ACTION_TABLE
    from pomcpp_tpu_torch.core import constants as C

    t = tgym.CLASSIC_ITEM_TABLE
    assert all(a == b for a, b in t.values())
    assert t["Rigid"][0] == C.C_RIGID and t["Fog"][0] == C.C_FOG
    assert t["Agent3"][0] == C.C_AGENT0 + 3
    assert tgym.CLASSIC_ACTION_TABLE["Bomb"][0] == C.M_BOMB


def _duel(batch):
    """Open board: agent 0 at (0, 0) next to agent 1 at (1, 0); agents 2
    and 3 far away.  A bomb planted by 0 kills both 0 and 1 unless they
    leave."""
    cs = empty_cell_state(batch, "cpu")
    xs, ys = (0, 1, 10, 0), (0, 0, 10, 10)
    board = torch.full_like(cs.board, C_PASSAGE)
    for i in range(4):
        board[:, xs[i] + 11 * ys[i]] = C_AGENT0 + i
    i32 = torch.int32
    return cs._replace(
        board=board,
        agent_x=torch.tensor(xs, dtype=i32).expand(batch, -1).contiguous(),
        agent_y=torch.tensor(ys, dtype=i32).expand(batch, -1).contiguous(),
    )


def _env_with(game, **kw):
    batch = game.board.shape[0]
    env = tgym.PommermanEnv(batch_size=kw.pop("batch_size", batch),
                            device="cpu", **kw)
    env.reset(seed=1)
    env._es = _fresh(env._es.key, game=game)
    return env


@pytest.mark.parametrize("team_mode", [False, True])
def test_scripted_kill_rewards_and_flags(team_mode):
    env = _env_with(_duel(2), team_mode=team_mode, max_episode_steps=40)
    bomb = np.array([[5, 0, 0, 0], [0, 0, 0, 0]])
    idle = np.zeros((2, 4), int)
    total = np.zeros((2, 4), np.float32)
    for t in range(11):
        obs, reward, term, trunc, info = env.step(bomb if t == 0 else idle)
        total += reward
        if t < 10:
            assert not reward.any() and not term.any() and not trunc.any()
    # Step 11: the bomb kills agents 0 and 1 on board 0; board 1 plays on.
    assert reward[0].tolist() == [-1.0, -1.0, 0.0, 0.0]
    assert not reward[1].any()
    assert info["alive"][0].tolist() == [False, False, True, True]
    assert reward.dtype == np.float32 and term.dtype == bool
    if team_mode:
        assert not term.any()              # one agent of each team is left
    else:
        assert not term.any() and info["winner"].tolist() == [-1, -1]


def test_win_reward_then_reset_step_reads_zero():
    game = _duel(2)
    dead = torch.zeros((2, 4), dtype=torch.bool)
    dead[0, 2:] = True                         # board 0: agents 0, 1 left
    game = game._replace(agent_dead=dead,
                         alive_count=4 - dead.sum(1, dtype=torch.int32))
    board = game.board.clone()
    board[0, 120] = board[0, 110] = C_PASSAGE
    env = _env_with(game._replace(board=board), max_episode_steps=30)
    acts = np.zeros((2, 4), int)
    acts[0, 0] = 5                             # 0 plants under itself
    env.step(acts)
    acts[0, 0] = 2                             # 0 walks down, out of line
    for t in range(10):
        if t == 1:
            acts[0, 0] = 4                     # then right: (1, 1) is clear
        if t == 2:
            acts[0, 0] = 2                     # and down to (1, 2)
        if t == 3:
            acts[0, 0] = 0
        obs, reward, term, trunc, info = env.step(acts)
        if t < 9:
            assert not reward.any()
    # Agent 1 idled next to the bomb and died; agent 0 wins board 0.
    assert reward[0].tolist() == [1.0, -1.0, 0.0, 0.0]
    assert term.tolist() == [True, False] and not trunc.any()
    assert info["winner"].tolist() == [0, -1]
    obs, reward, term, trunc, info = env.step(np.zeros((2, 4), int))
    assert not reward.any() and not term.any()           # the reset step
    assert info["timestep"].tolist() == [0, 12]
    assert info["alive"][0].all()


def test_draw_by_step_cap_is_truncated_and_single_env_strips_the_axis():
    env = tgym.PommermanEnv(max_episode_steps=3, fog="ego", view_range=2,
                            classic_encoding=True, device="cpu")
    obs, info = env.reset(seed=4)
    assert len(obs) == 4 and obs[0]["board"].shape == (5, 5)
    assert obs[0]["board"].dtype == np.int32
    assert obs[0]["bomb_life"].dtype == np.float64
    assert obs[0]["position"] == (0, 0) and obs[2]["position"] == (10, 10)
    assert obs[1]["alive"] == [10, 11, 12, 13] and obs[1]["teammate"] == 9
    assert obs[1]["enemies"] == [10, 12, 13]
    for t in range(3):
        obs, reward, term, trunc, info = env.step([0, 0, 0, 0])
        assert reward.shape == (4,) and not reward.any()
    assert bool(trunc) and not bool(term) and int(info["timestep"]) == 3
    frozen = env.step([1, 2, 3, 4])                 # no auto-reset: frozen
    assert int(frozen[4]["timestep"]) == 3 and bool(frozen[3])
    # render() draws board 0 as the JAX front end does.
    from pomcpp_tpu.engine.cellular import to_state as jax_to_state
    from pomcpp_tpu.render.ascii import render_state as jax_render
    from pomcpp_tpu_torch.convert import to_numpy
    from pomcpp_tpu_torch.engine.cellular import board_of

    drawn = env.render()
    assert drawn == jax_render(jax_to_state(to_numpy(board_of(env._es.game))),
                               color=False)
    assert drawn.splitlines()[-1] == "t=3 alive=4" and " 0 " in drawn
    with pytest.raises(ValueError, match="shape"):
        env.step(np.zeros((2, 4)))
    env.close()
    with pytest.raises(RuntimeError, match="reset"):
        env.step([0, 0, 0, 0])


def test_batched_env_matches_jax_env_on_idle_play():
    """Same protocol, shapes and dtypes as the JAX front end (the boards
    differ: each side draws its own)."""
    kw = dict(batch_size=3, fog="fog", max_episode_steps=5)
    et, ej = tgym.PommermanEnv(device="cpu", **kw), jgym.PommermanEnv(**kw)
    ot, it = et.reset(seed=2)
    oj, ij = ej.reset(seed=2)
    for _ in range(7):
        rt, rj = et.step(np.zeros((3, 4), int)), ej.step(np.zeros((3, 4), int))
        for a, c in zip(rt[1:4], rj[1:4]):
            assert a.shape == c.shape and a.dtype == c.dtype
            assert np.array_equal(a, c)
        assert rt[4].keys() == rj[4].keys()
        assert np.array_equal(rt[4]["timestep"], rj[4]["timestep"])
        for dt, dj in zip(rt[0], rj[0]):
            assert dt.keys() == dj.keys()
            for k in dt:
                assert dt[k].shape == dj[k].shape and dt[k].dtype == dj[k].dtype, k

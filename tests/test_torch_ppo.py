"""The port's PPO learner vs ``pomcpp_tpu.learner.ppo`` on the CPU.

``collect_rollout_batch`` is held against JAX's on 16 boards x 8 steps from
boards stepped 12 random steps (bombs in play, some agents dead), with a
step cap that falls inside the window: resets, deaths, wins and draws all
occur.  The JAX side runs unchanged but for its env functions, which the
test wraps (``ppo.py`` imports them at call time) to record each step's
fresh games -- ``_fresh`` of the key the collector hands the env -- and
each step's moves, and, for the mixed-control step, to run the Pallas chunk
in interpret mode on rands from a seeded table; its scripted opponents
(``_opponent_moves_batch``) are wrapped too, to record the random,
harmless and lazy moves and to run the unfused SimpleAgents
(``simple_agent_cell_act``) on rands from the same table.  The port gets
JAX's moves (``moves=``), those fresh games (``fresh=``), the same rands
(``rand_moves=``, ``opp_rands=``), the scripted moves (``opp_moves=``) and
the frozen slots' moves as the env took them (``frozen_moves=``).  Cases:
self-play, and every opponent of ``docs/TRAINING.md``'s curriculum --
random, harmless, lazy, simple fused and unfused, frozen, frozen+simple
fused and unfused.  Tolerance: every ``Transition`` field, the final env
state (every ``CellState`` field, ``done``, ``winner``, ``is_draw``; the
keys are each package's own) and the opponent state exact (the unfused
SimpleAgents' on the agents alive at the end: a dead agent's FSM follows
the chunk kernel in the port); ``value`` and ``boot_value`` within the
model's tolerance (0.005), ``logp`` within the logits' (0.02) on the rows of
live agents --
a dead agent's stored move is zeroed after its ``logp`` was taken of the
sampled move, and such rows are masked out of the loss.  Measured: value
2.3e-4, logp 6.8e-5.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from pomcpp_tpu.agents.simple_cellular import simple_agent_cell_act
from pomcpp_tpu.engine import pallas_step as jax_pallas
from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu.learner import ppo as jppo
from pomcpp_tpu.strategy.cellular_toolkit import danger_map_cell
from pomcpp_tpu_torch.convert import diff_fields, params_from_jax, to_torch
from pomcpp_tpu_torch.env.environment import EnvState, env_reset
from pomcpp_tpu_torch.learner import ppo as tppo

B, T = 16, 8
MODEL_TOL = {"value": 0.005, "logp": 0.02}

CASES = {
    "selfplay_unfused": dict(),
    "selfplay_fused": dict(fused_env=True),
    "simple_fused": dict(fused_env=True, opponent="simple",
                         learner_slots=(0,)),
    "random": dict(opponent="random", learner_slots=(0,)),
    "harmless": dict(opponent="harmless", learner_slots=(0,)),
    "lazy": dict(opponent="lazy", learner_slots=(0,)),
    "simple_unfused": dict(opponent="simple", learner_slots=(0,)),
    "frozen": dict(opponent="frozen", learner_slots=(0,)),
    "frozen_simple_unfused": dict(opponent="frozen+simple",
                                  learner_slots=(0,), frozen_slots=(1,)),
    "frozen_simple_fused": dict(opponent="frozen+simple", learner_slots=(0,),
                                frozen_slots=(1,), fused_env=True),
}


@pytest.fixture(scope="module")
def start_boards():
    """JAX boards stepped 12 random steps (by the port, whose env step
    equals JAX's); three of them nearly decided."""
    from pomcpp_tpu_torch.convert import to_numpy
    from pomcpp_tpu_torch.env.environment import env_step_auto_reset_batch

    keys = jax.random.split(jax.random.PRNGKey(3), B)
    es_j = jax.vmap(lambda k: jenv.env_reset(k, engine="cellular"))(keys)
    es = _to_port(es_j)
    rng = np.random.RandomState(9)
    for _ in range(12):
        es = env_step_auto_reset_batch(es, rng.randint(0, 6, (B, 4)),
                                       device="cpu")
    game = to_numpy(es.game)._replace(
        timestep=rng.randint(8, 14, B).astype(np.int32))
    dead = game.agent_dead.copy()
    dead[0, 1:] = True                    # a win at once, then a reset
    dead[1, [0, 2]] = True
    dead[2, :] = True                     # a draw at once
    game = game._replace(agent_dead=dead,
                         alive_count=(4 - dead.sum(1)).astype(np.int32))
    return es_j._replace(
        game=type(es_j.game)(*map(jnp.asarray, game)),
        done=jnp.asarray(es.done.numpy()), winner=jnp.asarray(es.winner.numpy()),
        is_draw=jnp.asarray(es.is_draw.numpy()))


def _joint_with_rands(cs, asts, rands):
    """JAX's ``simple_agent_cell_joint`` of one board on given rands."""
    dmap = danger_map_cell(cs)
    ids = jnp.arange(4, dtype=jnp.int32)
    moves, _, asts2 = jax.vmap(
        lambda aid, ast, r: simple_agent_cell_act(cs, aid, ast, r, dmap)
    )(ids, asts, rands)
    return moves, asts2


class Recorder:
    """Wraps the JAX env functions that ``collect_rollout_batch`` calls,
    and its scripted opponents: the random, harmless and lazy moves are
    recorded, the unfused SimpleAgents act on rands from the same table as
    the in-kernel ones; the moves each env step takes are recorded too
    (the frozen slots' moves are read from them)."""

    def __init__(self, monkeypatch, rands):
        self.fresh, self.rands = [], rands
        self.env_moves, self.opp_moves = [], []
        self.count = itertools.count()
        self.opp_count = itertools.count()
        step, step_fsm = (jenv.env_step_auto_reset_batch,
                          jenv.env_step_auto_reset_batch_fsm)
        opponents = jppo._opponent_moves_batch

        def record(es, rp, moves):
            games = jax.vmap(lambda k: jenv._fresh(k, "cellular", rp))(es.key)
            jax.debug.callback(
                lambda g: self.fresh.append(jax.tree.map(np.asarray, g)),
                games.game, ordered=True)
            jax.debug.callback(
                lambda m: self.env_moves.append(np.asarray(m)), moves,
                ordered=True)

        def wrapped_opp(name, keys, games, opp_state):
            if name == "simple":
                rand = io_callback(
                    lambda: self.rands[next(self.opp_count)],
                    jax.ShapeDtypeStruct((B, 4), jnp.int32), ordered=True)
                moves, opp2 = jax.vmap(_joint_with_rands)(games, opp_state,
                                                         rand)
                return jnp.where(games.agent_dead, 0, moves).astype(
                    jnp.int32), opp2
            moves, opp2 = opponents(name, keys, games, opp_state)
            jax.debug.callback(
                lambda m: self.opp_moves.append(np.asarray(m)), moves,
                ordered=True)
            return moves, opp2

        def wrapped(es, moves, team_mode=False, fused=False, max_steps=0,
                    randomize_positions=False):
            record(es, randomize_positions, moves)
            return step(es, moves, team_mode=team_mode, fused=fused,
                        max_steps=max_steps,
                        randomize_positions=randomize_positions)

        def wrapped_fsm(es, moves, fsm, slots, seed, team_mode=False,
                        max_steps=0, interpret=False, rand_moves=None,
                        randomize_positions=False):
            record(es, randomize_positions, moves)
            rand = io_callback(lambda: self.rands[next(self.count)],
                               jax.ShapeDtypeStruct((B, 4), jnp.int32),
                               ordered=True)
            return step_fsm(es, moves, fsm, slots, seed, team_mode=team_mode,
                            max_steps=max_steps, interpret=True,
                            rand_moves=rand,
                            randomize_positions=randomize_positions)

        monkeypatch.setattr(jenv, "env_step_auto_reset_batch", wrapped)
        monkeypatch.setattr(jenv, "env_step_auto_reset_batch_fsm", wrapped_fsm)
        monkeypatch.setattr(jppo, "_opponent_moves_batch", wrapped_opp)
        monkeypatch.setattr(jax_pallas, "pallas_step", functools.partial(
            jax_pallas.pallas_step, interpret=True))


def _to_port(es_j) -> EnvState:
    return EnvState(to_torch(es_j.game, "cpu"),
                    torch.from_numpy(np.array(es_j.done)),
                    torch.from_numpy(np.array(es_j.winner)),
                    torch.from_numpy(np.array(es_j.is_draw)),
                    env_reset(5, B, device="cpu").key)


def _port_model(params):
    model = tppo.ActorCritic()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_from_jax(params).items()})
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_collect_rollout_batch_matches_jax(monkeypatch, start_boards, case):
    kw = dict(rollout_len=T, max_episode_steps=18, **CASES[case])
    cfg_j, cfg_t = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    rands = np.random.RandomState(5).randint(0, 5, (T, B, 4)).astype(np.int32)
    rec = Recorder(monkeypatch, rands)
    ts = jppo.ppo_init(jax.random.PRNGKey(0), cfg_j)
    es_j = start_boards
    hooks = {}
    frozen = cfg_j.opponent.startswith("frozen")
    frozen_j = jppo.ppo_init(jax.random.PRNGKey(1), cfg_j).params \
        if frozen else None
    if cfg_j.opponent:
        opp0 = jppo.opponent_state_init(B, cfg_j)
        fin_j, traj_j, boot_j, opp_j = jax.jit(functools.partial(
            jppo.collect_rollout_batch, cfg=cfg_j, time_major=True,
            frozen_params=frozen_j))(ts.params, es_j, opp_state=opp0)
        kind = type(tppo.opponent_state_init(1, cfg_t, "cpu"))
        hooks = dict(opp_state=kind(*(torch.from_numpy(np.array(a))
                                      for a in opp0)),
                     rand_moves=torch.from_numpy(rands),
                     opp_rands=torch.from_numpy(rands))
        if rec.opp_moves:
            hooks["opp_moves"] = torch.from_numpy(np.stack(rec.opp_moves))
        if frozen:
            slots = tppo._roles(cfg_t)[1]
            hooks["frozen_model"] = _port_model(frozen_j)
            hooks["frozen_moves"] = torch.from_numpy(
                np.stack(rec.env_moves)[:, :, list(slots)])
    else:
        fin_j, traj_j, boot_j = jax.jit(functools.partial(
            jppo.collect_rollout_batch, cfg=cfg_j, time_major=True))(
                ts.params, es_j)
    jax.block_until_ready(traj_j)
    assert len(rec.fresh) == len(rec.env_moves) == T
    assert len(rec.opp_moves) == (T if cfg_j.opponent in ("random", "harmless",
                                                          "lazy") else 0)

    out = tppo.collect_rollout_batch(
        _port_model(ts.params), _to_port(es_j), cfg_t,
        torch.Generator().manual_seed(0),
        moves=torch.from_numpy(np.array(traj_j.move)),
        fresh=[to_torch(g, "cpu") for g in rec.fresh], device="cpu", **hooks)
    fin_t, traj_t, boot_t = out[:3]
    live = np.asarray(traj_j.alive)
    for name in traj_j._fields:
        ref = np.asarray(getattr(traj_j, name)).astype(np.float32)
        got = getattr(traj_t, name).float().numpy()
        assert ref.shape == got.shape, name
        if name in MODEL_TOL:
            err = np.abs(ref - got)
            assert (err[live] if name == "logp" else err).max() <= \
                MODEL_TOL[name], name
        else:
            assert np.array_equal(ref, got), name
    assert np.abs(np.asarray(boot_j) - boot_t.numpy()).max() <= \
        MODEL_TOL["value"]
    assert not diff_fields(fin_j.game, fin_t.game, skip=())
    for name in ("done", "winner", "is_draw"):
        assert np.array_equal(np.asarray(getattr(fin_j, name)),
                              getattr(fin_t, name).numpy()), name
    if cfg_j.opponent:
        assert len(opp_j) == len(out[3])
        # The unfused SimpleAgents' state: a dead agent's follows the chunk
        # kernel's rule in the port (agents/simple_cellular.py), so the rows
        # held are those of the agents alive at the end of the window (a
        # reset gives every row a fresh state); the kernel's state, all.
        rows = ~np.asarray(fin_j.game.agent_dead) \
            if type(out[3]).__name__ == "SimpleAgentState" \
            else np.ones((B, 4), bool)
        assert rows.sum() >= 2 * B
        for k, (a, b) in enumerate(zip(opp_j, out[3])):
            assert np.array_equal(np.asarray(a)[rows], b.numpy()[rows]), \
                f"opponent state array {k}"
    # The window holds what it is meant to hold.
    tr = traj_t
    assert int((~tr.valid).sum()) >= 3 and int(tr.draw.sum()) >= 2
    assert int((tr.reward > 0).sum()) >= 1 and int((tr.reward < 0).sum()) >= 1


@pytest.mark.parametrize("slots", [(0,), (1, 3), (0, 1, 2, 3), (2, 0, 2)],
                         ids=str)
def test_features_are_the_plain_crop_of_each_slot(start_boards, slots):
    """On CPU tensors the learner's features are the plain version: each
    slot's ``obs_to_features(observe_ego(game, slot))`` flattened, bit for
    bit, and ``out`` (a trajectory row) receives them in place."""
    from pomcpp_tpu_torch.env.observation import observe_ego
    from pomcpp_tpu_torch.models.actor_critic import obs_to_features

    game = _to_port(start_boards).game
    want = torch.stack([obs_to_features(observe_ego(game, s)).reshape(B, -1)
                        for s in slots], 1)
    got = tppo.ego_features(game, slots, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    traj = torch.zeros((2,) + tuple(want.shape), dtype=torch.bfloat16)
    row = traj[1]
    assert tppo.ego_features(game, slots, 4, out=row) is row
    assert torch.equal(traj[1].view(torch.int16), want.view(torch.int16))
    assert not traj[0].any()


def test_compute_gae_matches_jax():
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    rng = np.random.RandomState(4)
    t, b, n = 32, 8, 4
    reward = rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0], (t, b, n)).astype(np.float32)
    value = rng.randn(t, b, n).astype(np.float32)
    died = rng.rand(t, b, n) < 0.03
    done = rng.rand(t, b) < 0.08
    term = died | done[:, :, None]
    boot = rng.randn(b, n).astype(np.float32)
    assert term.any() and done.any()
    zeros = np.zeros((t, b, n), np.float32)
    traj_j = jppo.Transition(feats=zeros, move=zeros, logp=zeros,
                             value=jnp.asarray(value),
                             reward=jnp.asarray(reward), alive=zeros,
                             done=done, term=jnp.asarray(term), draw=done,
                             valid=done)
    adv_j, ret_j = jax.vmap(lambda tr, bv: jppo.compute_gae(tr, bv, cfg_j),
                            in_axes=(1, 0), out_axes=1)(traj_j,
                                                        jnp.asarray(boot))
    traj_t = tppo.Transition(*(torch.from_numpy(np.asarray(x)) for x in (
        zeros, zeros, zeros, value, reward, zeros, done, term, done, done)))
    adv, ret = tppo.compute_gae(traj_t, torch.from_numpy(boot), cfg_t)
    assert np.abs(np.asarray(adv_j) - adv.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(ret_j) - ret.numpy()).max() <= 1e-6

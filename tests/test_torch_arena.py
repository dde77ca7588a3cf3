"""The port's arena vs ``pomcpp_tpu.arena`` on the CPU.

``play_games`` is held against JAX's on 6 games of up to 96 steps (polled
every 32; three games finish in each line-up), with ``artifacts/ppo_randseat`` in the ``ppo`` slot, a
SimpleAgent and scripted slots, in FFA and in team mode.  The port gets
JAX's starting games (``es=``) and, through ``draws=``, the integers and
uniforms each slot draws from the key tree ``play_games`` walks
(``split(key)`` a step, ``split(k, games)``, ``split(., 4)`` a slot):
random and harmless moves, the SimpleAgent's rands, the ``ppo`` slot's
Gumbel uniforms.  ``GameResults`` must be equal: every game's done flag,
winner and draw flag, and the steps played.  The port's SimpleAgent slots
act through ``fsm_act`` (the FSM kernel's plain version here), whose dead
agents' moves differ from ``simple_agent_cell_act``'s and are zeroed in both
arenas.  ``simple_agent_cell_act`` / ``simple_agent_cell_policy``, the
per-slot act, equal JAX's for every living agent (moves, consumed flags and
state), acts carried over several steps.  ``League`` must give JAX's ratings exactly (the same Python float
arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu import arena as jarena
from pomcpp_tpu.agents import simple_cellular as jsimple
from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu.learner import ppo as jppo
from pomcpp_tpu.utils import restore_checkpoint as jax_restore
from pomcpp_tpu_torch import arena as tarena
from pomcpp_tpu_torch.agents import simple_cellular as tsimple
from pomcpp_tpu_torch.agents.simple import simple_agent_init
from pomcpp_tpu_torch.convert import to_torch
from pomcpp_tpu_torch.engine.cellular import cellular_step
from pomcpp_tpu_torch.env.environment import EnvState, env_reset
from pomcpp_tpu_torch.learner.ppo import PPOConfig, ppo_init
from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

GAMES, STEPS = 6, 96
CKPT = "artifacts/ppo_randseat"


@pytest.fixture(scope="module")
def nets():
    params = jax_restore(CKPT, jax.eval_shape(
        lambda: jppo.ppo_init(jax.random.PRNGKey(0)))).params
    model = restore_checkpoint(CKPT, ppo_init(0, PPOConfig(), "cpu")).model
    return params, model


def start_games(seed, games):
    """JAX's fresh games of ``play_games`` as (JAX EnvState, the port's)."""
    es_j = jax.vmap(lambda k: jenv.env_reset(k, engine="cellular"))(
        jax.random.split(jax.random.PRNGKey(seed), games))
    es = EnvState(to_torch(es_j.game, "cpu"),
                  torch.from_numpy(np.array(es_j.done)),
                  torch.from_numpy(np.array(es_j.winner)),
                  torch.from_numpy(np.array(es_j.is_draw)),
                  env_reset(seed, games, device="cpu").key)
    return es_j, es


def slot_draws(names, seed, games, steps):
    """Per step, each slot's draws as JAX's ``play_games`` makes them."""
    tiny = jnp.finfo(jnp.float32).tiny
    kinds = {
        "random": lambda k: jax.random.randint(k, (), 0, 6, jnp.int32),
        "harmless": lambda k: jax.random.randint(k, (), 0, 5, jnp.int32),
        "simple": lambda k: jax.random.randint(k, (), 0, 5, jnp.int32),
        "ppo": lambda k: jax.random.uniform(k, (6,), jnp.float32, tiny, 1.0),
    }

    @jax.jit
    def one(k):
        k4 = jax.vmap(lambda kg: jax.random.split(kg, 4))(
            jax.random.split(k, games))
        return [jax.vmap(kinds[n])(k4[:, i]) if n in kinds else None
                for i, n in enumerate(names)]

    key, out = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append([None if d is None else torch.from_numpy(np.array(d))
                    for d in one(k)])
    return out


@pytest.mark.parametrize("names, team", [
    (["random", "simple", "ppo", "random"], False),
    (["simple", "ppo", "random", "lazy"], True),
], ids=["ffa", "team"])
def test_play_games_matches_jax(nets, names, team):
    params, model = nets
    seed = 4
    ref = jarena.play_games(names, GAMES, STEPS, ppo_params=params,
                            seed=seed, team=team)
    _, es = start_games(seed, GAMES)
    got = tarena.play_games(names, GAMES, STEPS, nets=model, seed=seed,
                            team=team, device="cpu", es=es,
                            draws=slot_draws(names, seed, GAMES, STEPS))
    assert got.steps == ref.steps
    for field in ("done", "winners", "draws"):
        assert np.array_equal(getattr(ref, field), getattr(got, field)), field
    assert got.done.sum() >= 2 and (got.winners >= 0).sum() >= 1


def test_dict_roster_names_each_slot_its_net(nets):
    _, model = nets
    fresh = ppo_init(1, PPOConfig(), "cpu").model
    res = tarena.play_games(["ppo:a", "ppo:b", "random", "lazy"], 3, 4,
                            nets={"ppo:a": model, "ppo:b": fresh}, seed=5,
                            device="cpu")
    assert res.winners.shape == (3,) and res.steps == 4
    with pytest.raises(KeyError, match="ppo:c"):
        tarena.play_games(["ppo:a", "ppo:c", "random", "random"], 2, 2,
                          nets={"ppo:a": model}, device="cpu")


def test_moves_hook_plays_a_slots_moves_instead_of_its_policy():
    """``moves={slot: i32[T, G]}`` replaces that slot's policy (no net is
    asked for); with the same draws the other slots act as without it, and
    dead agents idle."""
    names = ["ppo", "simple", "random", "lazy"]
    es = env_reset(7, 3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    forced = torch.randint(0, 6, (5, 3), generator=gen, dtype=torch.int32)
    draws = [[torch.rand((3, 6), generator=gen),
              torch.randint(0, 5, (3,), generator=gen, dtype=torch.int32),
              torch.randint(0, 6, (3,), generator=gen, dtype=torch.int32),
              None] for _ in range(5)]
    rec, rec_free = [], []
    res = tarena.play_games(names, 3, 5, seed=7, es=es, device="cpu",
                            draws=draws, moves={0: forced}, record=rec)
    model = ppo_init(0, PPOConfig(), "cpu").model
    tarena.play_games(names, 3, 5, nets=model, seed=7, es=es, device="cpu",
                      draws=draws, record=rec_free)
    played = torch.stack(rec)
    assert res.steps == 5
    live = played[:, :, 0] != 0
    assert torch.equal(played[:, :, 0][live], forced[live])
    assert torch.equal(played[0, :, 1:], torch.stack(rec_free)[0, :, 1:])


def test_search_slots_play():
    """The planners' slots run, with small searches, beside a simple slot."""
    model = ppo_init(0, PPOConfig(), "cpu").model
    res = tarena.play_games(["mcts", "azmcts", "simple", "random"], 2, 3,
                            nets=model, device="cpu",
                            search_kwargs={"n_sim": 3, "max_tree_depth": 2})
    assert res.steps == 3 and res.done.shape == (2,)
    res = tarena.play_games(["lookahead", "simple", "lazy", "random"], 2, 2,
                            device="cpu",
                            search_kwargs={"depth": 2, "n_playouts": 2})
    assert res.steps == 2


@pytest.mark.parametrize("agent", [0, 3])
def test_simple_agent_cell_act_matches_jax(agent):
    """One agent's act over 8 boards, its state carried over 12 acts while
    the boards step with random moves (two agents die on board 1)."""
    es_j, es = start_games(2, 8)
    cs, cs_j = es.game, es_j.game
    ast = simple_agent_init((8,), "cpu")
    ast_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape),
                         jsimple.simple_agent_init())
    act_j = jax.jit(jax.vmap(jsimple.simple_agent_cell_act,
                             in_axes=(0, None, 0, 0)))
    rng = np.random.RandomState(agent)
    for t in range(12):
        rand = rng.randint(0, 5, 8).astype(np.int32)
        mv_j, used_j, ast_j = act_j(cs_j, agent, ast_j, jnp.asarray(rand))
        mv, used, ast = tsimple.simple_agent_cell_act(cs, agent, ast, rand)
        live = ~cs.agent_dead[:, agent].numpy()
        assert np.array_equal(np.asarray(mv_j)[live], mv.numpy()[live]), t
        assert np.array_equal(np.asarray(used_j)[live], used.numpy()[live])
        for a, b in zip(ast_j, ast):
            assert np.array_equal(np.asarray(a)[live], b.numpy()[live]), t
        moves = torch.from_numpy(rng.randint(0, 6, (8, 4)).astype(np.int32))
        moves[:, agent] = mv
        cs = cellular_step(cs, torch.where(cs.agent_dead, 0, moves))
        if t == 5:
            dead = cs.agent_dead.clone()
            dead[1, [1, 3]] = True
            cs = cs._replace(agent_dead=dead,
                             alive_count=(4 - dead.sum(1)).to(torch.int32))
        cs_j = type(cs_j)(*(jnp.asarray(x.numpy()) for x in cs))
    gen = torch.Generator().manual_seed(0)
    mv, ast2 = tsimple.simple_agent_cell_policy(gen, cs, agent, ast)
    assert mv.shape == (8,) and ast2.rp_count.shape == (8,)


def test_league_matches_jax():
    rng = np.random.RandomState(0)
    roster = ["a", "b", "c", "d", "e"]
    lj, lt = jarena.League(roster), tarena.League(roster)
    for _ in range(6):
        lineup = list(rng.choice(roster, 4))
        done = rng.rand(8) < 0.8
        winners = rng.randint(-1, 4, 8).astype(np.int32)
        draws = (winners < 0) & done
        lj.record(lineup, jarena.GameResults(done, winners, draws, 10))
        lt.record(lineup, tarena.GameResults(done, winners, draws, 10))
    assert lt.ratings == lj.ratings
    assert lt.games_played == lj.games_played
    assert lt.table() == lj.table()
    assert tarena.elo_expected(1300.0, 1200.0) == \
        jarena.elo_expected(1300.0, 1200.0)


def test_evaluate_and_league_mains(capsys):
    """``python -m pomcpp_tpu_torch.evaluate`` / ``.league`` on the CPU:
    named checkpoints, seat rotation, team seatings and the Elo table."""
    from pomcpp_tpu_torch import evaluate, league

    evaluate.main(["--games", "4", "--steps", "6", "--agents",
                   "ppo:a,simple,ppo:b,random", "--ckpt",
                   f"a={CKPT},b=artifacts/ppo_vs_simple", "--rotate",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("games=4 steps_played<=6")
    assert "seats(random)" in out
    evaluate.main(["--games", "4", "--steps", "4", "--agents",
                   "ppo,simple,lazy,simple", "--ckpt", CKPT, "--team",
                   "--rotate", "--device", "cpu"])
    assert "games=4" in capsys.readouterr().out
    league.main(["--roster", "simple,random,ppo", "--rounds", "2", "--games",
                 "2", "--steps", "4", "--ckpt", CKPT, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 1:" in out and "Elo table:" in out
    assert all(name in out for name in ("simple", "random", "ppo"))

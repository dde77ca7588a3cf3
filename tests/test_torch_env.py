"""The port's env layer vs ``pomcpp_tpu.env.environment`` on the CPU.

Inputs come from numpy seeds.  The JAX side's fresh games are computed from
its keys (``_fresh``) and injected into the port through ``fresh=``; the
fused path runs ``pallas_step`` / ``pallas_rollout_chunk`` in interpret
mode.  Tolerance: exact equality of every ``CellState`` field and of
``done`` / ``winner`` / ``is_draw`` after every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.engine import pallas_step as jax_pallas
from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu_torch.agents.basic import harmless_agent, lazy_agent, random_agent
from pomcpp_tpu_torch.convert import diff_fields, fsm_to_torch, to_torch
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
from pomcpp_tpu_torch.env import environment as tenv
from pomcpp_tpu_torch.env.environment import EnvState

B, STEPS = 8, 24


def _jax_reset(seed, rp=False, b=B):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return jax.vmap(
        lambda k: jenv.env_reset(k, engine="cellular", randomize_positions=rp)
    )(keys)


def _kill(es, dead):
    """Mark agents dead (numpy bool[B, 4]) in a JAX EnvState."""
    game = es.game._replace(
        agent_dead=jnp.asarray(dead),
        alive_count=jnp.asarray(4 - dead.sum(1), jnp.int32))
    return es._replace(game=game)


def _scenario(seed, rp=False):
    """Boards 0-1 one agent left (win at once), board 2 nobody left (draw),
    board 3 agents 1 and 3 left (one team), board 4 done at entry; the rest
    play on."""
    es = _jax_reset(seed, rp)
    dead = np.zeros((B, 4), bool)
    dead[0, 1:] = True
    dead[1, [0, 1, 3]] = True
    dead[2, :] = True
    dead[3, [0, 2]] = True
    es = _kill(es, dead)
    done = np.zeros(B, bool)
    done[4] = True
    winner = np.full(B, -1, np.int32)
    winner[4] = 2
    return es._replace(done=jnp.asarray(done), winner=jnp.asarray(winner))


def _to_port(es_j, seed=5) -> EnvState:
    key = tenv.env_reset(seed, es_j.done.shape[0], device="cpu").key
    return EnvState(
        to_torch(es_j.game, "cpu"),
        torch.from_numpy(np.array(es_j.done)),
        torch.from_numpy(np.asarray(es_j.winner).astype(np.int32)),
        torch.from_numpy(np.array(es_j.is_draw)),
        key,
    )


def _jax_fresh_games(es_j, rp):
    return jax.vmap(lambda k: jenv._fresh(k, "cellular", rp))(es_j.key).game


def _assert_same(es_j, es_t, where):
    bad = diff_fields(es_j.game, es_t.game, skip=())
    assert not bad, f"{where}: game fields differ: {bad}"
    for name in ("done", "winner", "is_draw"):
        assert np.array_equal(np.asarray(getattr(es_j, name)),
                              getattr(es_t, name).numpy()), f"{where}: {name}"


def _moves(seed, steps=STEPS, b=B, hi=6):
    return np.random.RandomState(seed).randint(
        0, hi, size=(steps, b, 4)).astype(np.int32)


@pytest.fixture
def interpret_pallas_step(monkeypatch):
    """The JAX env's fused path on the CPU: ``pallas_step`` in interpret
    mode, as tests/test_pallas_step.py runs it."""
    monkeypatch.setattr(
        jax_pallas, "pallas_step",
        functools.partial(jax_pallas.pallas_step, interpret=True))


@pytest.mark.parametrize("team_mode,max_steps,rp", [
    (False, 0, False),
    (False, 7, False),
    (True, 9, False),
    (False, 6, True),
])
def test_fused_env_step_matches_jax(interpret_pallas_step, team_mode,
                                    max_steps, rp):
    es_j = _scenario(3, rp)
    es_t = _to_port(es_j)
    moves = _moves(11)
    seen_reset = seen_draw = seen_win = False
    for t in range(STEPS):
        fresh = to_torch(_jax_fresh_games(es_j, rp), "cpu")
        was_done = np.asarray(es_j.done)
        es_j = jenv.env_step_auto_reset_batch(
            es_j, jnp.asarray(moves[t]), team_mode=team_mode, fused=True,
            max_steps=max_steps, randomize_positions=rp)
        es_t = tenv.env_step_auto_reset_batch(
            es_t, moves[t], team_mode=team_mode, fused=True,
            max_steps=max_steps, randomize_positions=rp, fresh=fresh,
            device="cpu")
        _assert_same(es_j, es_t, f"step {t}")
        seen_reset |= bool(was_done.any())
        seen_draw |= bool(es_t.is_draw.any())
        seen_win |= bool((es_t.winner >= 0).any())
    assert seen_reset and seen_draw and seen_win
    if max_steps:
        assert int(es_t.game.timestep.max()) <= max_steps


def test_unfused_env_step_matches_vmapped_jax():
    es_j = _scenario(4)
    es_t = _to_port(es_j)
    moves = _moves(12)
    step_j = jax.jit(jax.vmap(
        lambda e, m: jenv.env_step_auto_reset(e, m, False, 8, False)))
    for t in range(STEPS):
        fresh = to_torch(_jax_fresh_games(es_j, False), "cpu")
        es_j = step_j(es_j, jnp.asarray(moves[t]))
        es_t = tenv.env_step_auto_reset_batch(
            es_t, moves[t], fused=False, max_steps=8, fresh=fresh,
            device="cpu")
        _assert_same(es_j, es_t, f"step {t}")


def test_env_step_without_reset_freezes_finished_games():
    es_j = _scenario(6)
    es_t = _to_port(es_j)
    moves = _moves(13, steps=6)
    step_j = jax.jit(jax.vmap(lambda e, m: jenv.env_step(e, m, False, 4)))
    for t in range(6):
        es_j = step_j(es_j, jnp.asarray(moves[t]))
        es_t = tenv.env_step(es_t, moves[t], max_steps=4, device="cpu")
        _assert_same(es_j, es_t, f"step {t}")
    assert es_t.done.all()                      # max_steps = 4 ended them all
    frozen = tenv.env_step(es_t, moves[0], max_steps=4, device="cpu")
    assert not diff_fields(frozen.game, es_t.game, skip=())


@pytest.mark.parametrize("team_mode", [False, True])
def test_fsm_env_step_matches_jax(team_mode):
    """``env_step_auto_reset_batch_fsm`` with ``rand_moves``: the in-kernel
    SimpleAgents on lanes 1-3, the learner on lane 0; both sides reset the
    FSM rows of boards that were done, as the caller must."""
    steps, b, slots = 12, 4, (0,)
    es_j = _jax_reset(21, b=b)
    dead = np.zeros((b, 4), bool)
    dead[0, 1:] = True                       # wins at once, resets after
    dead[1, [0, 2]] = True
    es_j = _kill(es_j, dead)
    es_t = _to_port(es_j)
    rng = np.random.RandomState(22)
    rands = rng.randint(0, 5, size=(steps, b, 4)).astype(np.int32)
    learner = rng.randint(0, 6, size=(steps, b, 4)).astype(np.int32)
    init = [np.array(a) for a in jax_pallas.simple_fsm_state_init(b)]
    fsm_j = tuple(map(jnp.asarray, init))
    fsm_t = fsm_to_torch(init, "cpu")
    resets = 0
    for t in range(steps):
        fresh = to_torch(_jax_fresh_games(es_j, False), "cpu")
        was_done = np.asarray(es_j.done)
        es_j, fsm_j = jenv.env_step_auto_reset_batch_fsm(
            es_j, jnp.asarray(learner[t]), fsm_j, slots, 0,
            team_mode=team_mode, max_steps=9, interpret=True,
            rand_moves=jnp.asarray(rands[t]))
        es_t, fsm_t = tenv.env_step_auto_reset_batch_fsm(
            es_t, learner[t], fsm_t, slots, 0, team_mode=team_mode,
            max_steps=9, rand_moves=rands[t], fresh=fresh, device="cpu")
        _assert_same(es_j, es_t, f"step {t}")
        for k, (a, c) in enumerate(zip(fsm_j, fsm_t)):
            assert np.array_equal(np.asarray(a), c.numpy()), \
                f"step {t}: FSM array {k}"
        resets += int(was_done.sum())
        keep = ~was_done[:, None]
        fsm_j = tuple(jnp.where(keep, a, i) for a, i in zip(fsm_j, init))
        fsm_t = type(fsm_t)(*(torch.where(torch.from_numpy(keep), a,
                                          torch.from_numpy(i))
                              for a, i in zip(fsm_t, init)))
    assert resets >= 2 and bool(es_t.game.timestep.max() <= 9)


# (dead, timestep, was_done, team_mode, max_steps) -> (done, winner, is_draw)
TERMINAL_CASES = [
    ((0, 0, 0, 0), 3, False, False, 0, (False, -1, False)),
    ((1, 1, 0, 1), 3, False, False, 0, (True, 2, False)),
    ((0, 1, 1, 1), 3, False, False, 0, (True, 0, False)),
    ((1, 1, 1, 1), 3, False, False, 0, (True, -1, True)),
    ((0, 0, 1, 1), 10, False, False, 10, (True, -1, True)),
    ((0, 0, 1, 1), 9, False, False, 10, (False, -1, False)),
    ((1, 0, 1, 1), 10, False, False, 10, (True, 1, False)),
    ((1, 0, 1, 0), 3, False, True, 0, (True, 1, False)),
    ((0, 1, 0, 1), 3, False, True, 0, (True, 0, False)),
    ((0, 1, 1, 1), 3, False, True, 0, (True, 0, False)),
    ((0, 1, 1, 0), 3, False, True, 0, (False, -1, False)),
    ((1, 1, 1, 1), 3, False, True, 0, (True, -1, True)),
    ((0, 1, 1, 0), 12, False, True, 12, (True, -1, True)),
    ((1, 1, 0, 1), 3, True, False, 0, (True, -1, False)),
]


@pytest.mark.parametrize("dead,timestep,was_done,team_mode,max_steps,want",
                         TERMINAL_CASES)
def test_detect_terminal_case_table(dead, timestep, was_done, team_mode,
                                    max_steps, want):
    es_j = _jax_reset(1, b=2)
    d = np.array([dead, dead], bool)
    es_j = _kill(es_j, d)
    es_j = es_j._replace(
        game=es_j.game._replace(timestep=jnp.full((2,), timestep, jnp.int32)),
        done=jnp.full((2,), was_done))
    got = tenv._detect_terminal(_to_port(es_j), team_mode, max_steps)
    ref = jax.vmap(lambda e: jenv._detect_terminal(e, team_mode, max_steps))(es_j)
    _assert_same(ref, got, "terminal")
    assert (bool(got.done[0]), int(got.winner[0]), bool(got.is_draw[0])) == want


def test_reset_stream_is_deterministic_and_branch_free_draw_agrees():
    """The port's own resets: a pure function of the key rows, so drawing
    for the done boards only and drawing for every board give one result."""
    es = tenv.env_reset(7, 16, randomize_positions=True, device="cpu")
    again = tenv.env_reset(7, 16, randomize_positions=True, device="cpu")
    assert not diff_fields(es.game, again.game, skip=())
    assert torch.equal(es.key[:, 2], torch.ones(16, dtype=torch.int64))
    other = tenv.env_reset(8, 16, randomize_positions=True, device="cpu")
    assert diff_fields(es.game, other.game, skip=())
    moves = _moves(14, steps=30, b=16)
    runs = []
    for always in (False, True):
        e = es
        for t in range(30):
            fresh = tenv._draw_fresh_game(e.key, True) if always else None
            e = tenv.env_step_auto_reset_batch(
                e, moves[t], fused=True, max_steps=5,
                randomize_positions=True, fresh=fresh, device="cpu")
        runs.append(e)
    assert not diff_fields(runs[0].game, runs[1].game, skip=())
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1:], runs[1][1:]))
    # 30 steps with max_steps=5: every board was reset five times
    # (6-step cycle), each time from a new counter value.
    assert torch.equal(runs[0].key[:, 2], torch.full((16,), 6))
    first = tenv._draw_fresh_game(es.key, True)
    assert diff_fields(first, es.game, skip=())     # a reset is a new board


def test_reset_draw_distribution():
    es = tenv.env_reset(3, 2000, device="cpu")
    interior = np.ones(121, bool)
    interior[[0, 10, 110, 120]] = False
    board = es.game.board.numpy()[:, interior]
    assert abs((board == 1).mean() - 1 / 7) < 0.01
    assert abs((board == 2).mean() - 1 / 7) < 0.01
    hidden = es.game.hidden_pow.numpy()[:, interior]
    assert ((hidden > 0) <= (board == 2)).all()
    assert abs((hidden > 0).sum() / (board == 2).sum() - 0.5) < 0.02
    assert set(np.unique(hidden)) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("own_stream", [False, True])
def test_randomize_positions_is_a_uniform_corner_permutation(own_stream):
    n = 4800
    if own_stream:
        cs = tenv.env_reset(2, n, randomize_positions=True, device="cpu").game
    else:
        cs = random_cell_state(n, seed=2, device="cpu",
                               randomize_positions=True)
    x, y = cs.agent_x.numpy(), cs.agent_y.numpy()
    assert np.isin(x, (0, 10)).all() and np.isin(y, (0, 10)).all()
    corner = (x // 10) + 2 * (y // 10)          # 0..3, one per agent
    assert (np.sort(corner, 1) == np.arange(4)).all()
    code = cs.board.numpy()[np.arange(n)[:, None], x + 11 * y]
    assert (code == 10 + np.arange(4)).all()
    perms, counts = np.unique(corner, axis=0, return_counts=True)
    assert len(perms) == 24
    assert counts.min() > 130 and counts.max() < 270     # mean 200
    fixed = random_cell_state(4, seed=2, device="cpu")
    assert fixed.agent_x.tolist() == [[0, 10, 10, 0]] * 4


@pytest.mark.parametrize("policy,hi", [(lazy_agent, 0), (harmless_agent, 4),
                                       (random_agent, 5)])
def test_rollout_metrics_and_policies(policy, hi):
    gen = torch.Generator().manual_seed(0)
    es = tenv.env_reset(1, 6, device="cpu")
    mv = policy(gen, es.game, torch.arange(4))
    assert mv.shape == (6, 4) and mv.dtype == torch.int32
    assert int(mv.min()) >= 0 and int(mv.max()) <= hi
    out, metrics = tenv.rollout(es, policy, 10, max_steps=4, generator=gen,
                                device="cpu")
    assert set(metrics) == {"done", "winner", "alive"}
    assert all(v.shape == (10, 6) for v in metrics.values())
    if policy is not random_agent:
        # Nobody dies: draws at timestep 4, a reset on the step after.
        assert metrics["done"][:, 0].tolist() == \
            [False, False, False, True, False] * 2
        assert (metrics["alive"] == 4).all() and (metrics["winner"] == -1).all()


def test_rollout_stateful_resets_policy_state():
    def act(generator, game, pstate):
        return (harmless_agent(generator, game, torch.arange(4)),
                tuple(p + 1 for p in pstate))

    gen = torch.Generator().manual_seed(0)
    es = tenv.env_reset(1, 3, device="cpu")
    zero = torch.zeros((3, 4), dtype=torch.int32)
    out, ps, metrics = tenv.rollout_stateful(
        es, act, (zero, zero), 10, reset_policy_state=(zero, zero), joint=True,
        max_steps=4, generator=gen, device="cpu")
    # Done after steps 4 and 9; the state is zeroed on steps 5 and 10.
    assert isinstance(ps, tuple) and torch.equal(ps[0], zero)
    assert metrics["done"].shape == (10, 3) and metrics["done"][3].all()
    out, ps, _ = tenv.rollout_stateful(
        es, lambda g, game, ids, p: (lazy_agent(g, game, ids), p + 1), zero,
        7, auto_reset=False, generator=gen, device="cpu")
    assert torch.equal(ps, zero + 7) and not out.done.any()


def test_exact_engine_and_missing_card_are_errors():
    """The exact engine is ported: ``engine="exact"`` gives queue-encoded
    games, which the fused paths refuse; an unknown engine and a missing
    card are errors."""
    from pomcpp_tpu_torch.core.state import State

    exact = tenv.env_reset(0, 2, engine="exact", device="cpu")
    assert isinstance(exact.game, State)
    with pytest.raises(ValueError, match="CellState"):
        tenv.env_step_auto_reset_batch(exact, np.zeros((2, 4)), fused=True,
                                       device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tenv.env_reset(0, 2, engine="planes", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tenv.env_reset(0, 2)
        es = tenv.env_reset(0, 2, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            tenv.env_step_auto_reset_batch(es, np.zeros((2, 4)), fused=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            tenv.env_step_auto_reset_batch_fsm(
                es, np.zeros((2, 4)), simple_fsm_state_init(2, "cpu"), (0,), 1)

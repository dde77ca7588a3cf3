"""The port's search distillation vs ``pomcpp_tpu.learner.distill`` on the
CPU.

JAX's ``az_train_step`` of the net ``artifacts/ppo_randseat`` on 4 boards x
3 steps, 4 sims, tree depth 2 (playout depth 2), ``fused_env=True``, from
boards stepped 12 random steps with agents dead, one game won and one drawn
at once and a step cap inside the window: resets, deaths and masked rows
all occur.  Twice: unguided (``mcts_moves_pallas`` with its chunk kernel in
interpret mode) and guided (``--guided``, ``mcts_moves_net`` on the net).

The JAX side runs unchanged but for wrappers.  Its collector records the
rollout it returns.  Its env step and its per-agent planner run through
``jax.pure_callback`` as their own jitted JAX functions: the env step
records each step's fresh games (``_fresh`` of the keys it is handed), and
the collector's four searches a step run one compiled planner instead of
four inlined copies (the same function and results; the compile, not the
run, is what a test here pays for).  The port gets the same start, JAX's
search draws and Gumbel uniforms (from the key tree ``az_train_step``
walks), those fresh games and JAX's permutation.  Tolerances:

* ``collect_search_rollout``, unguided: the final env state, feats, probs,
  value targets (a sum of six products, in move order) and weights bit for
  bit.  Guided: the same, but the value targets within 1e-4 (root Q of
  ``mcts_moves_net``, whose logits are within 1.6e-5 of JAX's; the bound
  ``tests/test_torch_search.py`` holds its root Q to), root visits, and so
  probs, moves and the env, exact.
* ``_loss`` on the recorded batch with ``artifacts/ppo_randseat``: the
  loss within 3e-3 relative and each gradient leaf within the relative L2
  bounds ``tests/test_torch_model.py`` holds ``_ppo_loss`` to (0.3 for the
  conv biases, 0.03 for the rest).
* One ``az_train_step`` update, unguided and guided (two minibatches, two
  Adam steps) warm-started from ``artifacts/ppo_randseat`` with its Adam
  state, as ``train_az --resume`` starts: the metrics within 3e-3
  relative, and each leaf's parameter change within 0.05 relative L2
  (measured, unguided: 0.018 for the first conv's bias, whose gradient sums
  a bf16 gradient over every position, 0.0035 or less for every other
  leaf).
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu import search as jsearch
from pomcpp_tpu.engine import pallas_step as jax_pallas
from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu.learner import distill as jdistill
from pomcpp_tpu.learner import ppo as jppo
from pomcpp_tpu.utils import restore_checkpoint as jax_restore
from pomcpp_tpu_torch.convert import (
    diff_fields,
    params_to_jax,
    to_numpy,
    to_torch,
)
from pomcpp_tpu_torch.env.environment import (
    EnvState,
    env_reset,
    env_step_auto_reset_batch,
)
from pomcpp_tpu_torch.learner import distill as tdistill
from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

B, T = 4, 3
CKPT = "artifacts/ppo_randseat"
KW = dict(rollout_len=T, n_sim=4, depth=2, max_tree_depth=2,
          num_minibatches=2, fused_env=True, max_episode_steps=14)
GUIDED_Q_TOL = 1e-4


def jax_train_state(cfg=jdistill.DistillConfig()):
    """JAX's ``TrainState`` restored from ``CKPT``; the template is the
    tree of shapes, so no net is initialised."""
    return jax_restore(CKPT, jax.eval_shape(
        lambda: jdistill.distill_init(jax.random.PRNGKey(0), cfg)))


def pallas_draws(key, b, n_sim, tree, depth):
    """The integers ``mcts_moves_pallas`` draws from ``key``."""
    def sim(k):
        k_sel, k_play = jax.random.split(k)
        opp = jax.vmap(lambda ko: jax.random.randint(ko, (b, 4), 0, 6,
                                                     jnp.int32))(
            jax.random.split(k_sel, tree))
        return opp, jax.random.randint(k_play, (depth, b, 4), 0, 6, jnp.int32)

    opp, play = jax.vmap(sim)(jax.random.split(key, n_sim))
    return {"opponents": torch.from_numpy(np.array(opp)),
            "playout": torch.from_numpy(np.array(play))}


def net_draws(key, b, n_sim, tree):
    """The opponents' integers ``mcts_moves_net`` (the vmapped
    ``_tree_search``) draws from ``key``: ``split(key, b)`` a board, then
    ``split(k, n_sim)``, ``split(k) -> k_opp, k_play``, ``split(k_opp,
    tree)``."""
    def board(kb):
        def sim(k):
            k_opp, _ = jax.random.split(k)
            return jax.vmap(lambda ko: jax.random.randint(
                ko, (4,), 0, 6, jnp.int32))(jax.random.split(k_opp, tree))
        return jax.vmap(sim)(jax.random.split(kb, n_sim))

    opp = jax.vmap(board)(jax.random.split(key, b))
    return {"opponents": torch.from_numpy(np.array(
        jnp.transpose(opp, (1, 2, 0, 3))))}


def rollout_draws(k_roll, cfg):
    """Per step: the four searches' draws and the Gumbel uniforms of
    ``collect_search_rollout`` under ``k_roll``."""
    tiny = jnp.finfo(jnp.float32).tiny
    out = []
    for k in jax.random.split(k_roll, cfg.rollout_len):
        ks = jax.random.split(k, 5)
        search = [net_draws(ks[a], B, cfg.n_sim, cfg.max_tree_depth)
                  if cfg.guided else
                  pallas_draws(ks[a], B, cfg.n_sim, cfg.max_tree_depth,
                               cfg.depth) for a in range(4)]
        out.append({"search": search, "uniforms": torch.from_numpy(
            np.array(jax.random.uniform(ks[4], (B, 4, 6), jnp.float32, tiny,
                                        1.0)))})
    return out


def host_call(run, shapes, *args):
    """``run(*args)``, a jitted JAX function whose results have ``shapes``,
    called from a traced computation through ``jax.pure_callback``."""
    return jax.pure_callback(
        lambda *a: jax.tree.map(np.asarray, run(*a)), shapes, *args)


def _shapes(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


# A planner's results: moves i32[B], root visits i32[B, 6], root Q f32[B, 6].
PLAN_SHAPES = (jax.ShapeDtypeStruct((B,), jnp.int32),
               jax.ShapeDtypeStruct((B, 6), jnp.int32),
               jax.ShapeDtypeStruct((B, 6), jnp.float32))


def _to_port(es_j) -> EnvState:
    return EnvState(to_torch(es_j.game, "cpu"),
                    torch.from_numpy(np.array(es_j.done)),
                    torch.from_numpy(np.array(es_j.winner)),
                    torch.from_numpy(np.array(es_j.is_draw)),
                    env_reset(5, B, device="cpu").key)


def _port_ts(cfg):
    return restore_checkpoint(CKPT, tdistill.distill_init(0, cfg, "cpu"))


@pytest.fixture(scope="module")
def start():
    """JAX boards stepped 12 random steps by the port (whose env step
    equals JAX's); board 0 won at once, board 1 drawn at once."""
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    es_j = jax.vmap(lambda k: jenv.env_reset(k, engine="cellular"))(keys)
    es = _to_port(es_j)
    rng = np.random.RandomState(9)
    for _ in range(12):
        es = env_step_auto_reset_batch(es, rng.randint(0, 6, (B, 4)),
                                       device="cpu")
    game = to_numpy(es.game)._replace(
        timestep=np.array([5, 6, 12, 10], np.int32))
    dead = game.agent_dead.copy()
    dead[0, 1:] = True
    dead[1, :] = True
    dead[3, 2] = True
    game = game._replace(agent_dead=dead,
                         alive_count=(4 - dead.sum(1)).astype(np.int32))
    return es_j._replace(
        game=type(es_j.game)(*map(jnp.asarray, game)),
        done=jnp.asarray(es.done.numpy()), winner=jnp.asarray(es.winner.numpy()),
        is_draw=jnp.asarray(es.is_draw.numpy()))


@functools.lru_cache(maxsize=None)
def _jax_env_step(max_steps):
    """JAX's fused env step, jitted, returning its fresh games too."""
    step = functools.partial(jenv.env_step_auto_reset_batch, fused=True,
                             max_steps=max_steps)
    pallas = functools.partial(jax_pallas.pallas_step, interpret=True)

    @jax.jit
    def run(es, moves):
        games = jax.vmap(lambda k: jenv._fresh(k, "cellular"))(es.key)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_pallas, "pallas_step", pallas)
            return step(es, moves), games.game

    return run


def _jax_az_step(start, guided):
    """JAX's ``az_train_step`` with the fresh games and the rollout
    recorded, and the draws and permutation the port needs."""
    cfg = jdistill.DistillConfig(interpret=True, guided=guided, **KW)
    ts = jax_train_state(cfg)
    fresh, rollout = [], []
    collect = jdistill.collect_search_rollout
    env_run = _jax_env_step(cfg.max_episode_steps)

    def env_host(es, moves):
        es2, games = env_run(es, moves)
        fresh.append(jax.tree.map(np.asarray, games))
        return es2

    def env_step(es, moves, team_mode=False, fused=False, max_steps=0,
                 randomize_positions=False):
        assert fused and not team_mode and max_steps == cfg.max_episode_steps
        return host_call(env_host, _shapes(es), es, moves)

    pallas_run = functools.partial(
        jsearch.mcts_moves_pallas, n_sim=cfg.n_sim, depth=cfg.depth,
        max_tree_depth=cfg.max_tree_depth, interpret=True)
    net_run = jax.jit(lambda g, a, k, p: jsearch.mcts_moves_net(
        g, a, k, jppo._MODEL.apply, p, n_sim=cfg.n_sim,
        max_tree_depth=cfg.max_tree_depth))

    def pallas_search(game, agent, key, **kw):
        return host_call(pallas_run, PLAN_SHAPES, game, agent, key)

    def net_search(game, agent, key, apply_fn, params, **kw):
        return host_call(net_run, PLAN_SHAPES, game, agent, key, params)

    def recorded(es, key, cfg, params=None):
        out = collect(es, key, cfg, params)
        jax.debug.callback(
            lambda o: rollout.append(jax.tree.map(np.asarray, o)), out,
            ordered=True)
        return out

    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(jdistill, "env_step_auto_reset_batch", env_step)
        mp.setattr(jdistill, "collect_search_rollout", recorded)
        mp.setattr(jdistill, "mcts_moves_pallas", pallas_search)
        mp.setattr(jdistill, "mcts_moves_net", net_search)
        ts2, es2, metrics = jdistill.az_train_step(ts, start, cfg)
        jax.block_until_ready(ts2.params)
    assert len(fresh) == T and len(rollout) == 1
    _, k_roll, k_perm = jax.random.split(ts.key, 3)
    n = T * B * 4
    return {"cfg": cfg, "ts": ts, "ts2": ts2, "metrics": metrics,
            "rollout": rollout[0], "fresh": fresh,
            "draws": rollout_draws(k_roll, cfg),
            "perm": torch.from_numpy(np.array(
                jax.random.permutation(k_perm, n)))}


@pytest.fixture(scope="module")
def jax_run(start):
    return _jax_az_step(start, guided=False)


@pytest.fixture(scope="module")
def jax_guided(start):
    return _jax_az_step(start, guided=True)


def _port_collect(start, run, guided):
    cfg = tdistill.DistillConfig(guided=guided, **KW)
    return tdistill.collect_search_rollout(
        _to_port(start), cfg, torch.Generator().manual_seed(0),
        _port_ts(cfg).model if guided else None, draws=run["draws"],
        fresh=[to_torch(g, "cpu") for g in run["fresh"]], device="cpu")


def _expect_rollout(run, out, value_tol):
    es_j, feats_j, probs_j, value_j, weight_j = run["rollout"]
    es, feats, probs, value_t, weight = out
    assert not diff_fields(es_j.game, es.game, skip=())
    for name in ("done", "winner", "is_draw"):
        assert np.array_equal(np.asarray(getattr(es_j, name)),
                              getattr(es, name).numpy()), name
    assert np.array_equal(np.asarray(feats_j).astype(np.float32),
                          feats.float().numpy())
    assert np.array_equal(probs_j, probs.numpy())
    assert np.array_equal(weight_j, weight.numpy())
    assert np.abs(value_j - value_t.numpy()).max() <= value_tol
    # The window holds what it is meant to hold.
    assert (weight_j == 0).sum() >= 8 and (weight_j == 1).sum() >= 8
    assert np.unique(value_j).size > 2
    assert int((es.game.timestep < T).sum()) >= 2      # boards were reset


def test_collect_search_rollout_matches_jax(start, jax_run):
    _expect_rollout(jax_run, _port_collect(start, jax_run, False), 0.0)


def test_guided_collect_search_rollout_matches_jax(start, jax_guided):
    """AlphaZero mode: ``mcts_moves_net`` on the checkpoint's net plans."""
    _expect_rollout(jax_guided, _port_collect(start, jax_guided, True),
                    GUIDED_Q_TOL)


def test_loss_and_grads_match_jax(jax_run):
    cfg_j = jax_run["cfg"]
    params = jax_run["ts"].params
    _, feats, probs, value_t, weight = jax_run["rollout"]
    batch_j = tuple(jnp.asarray(x.reshape((-1,) + x.shape[3:]))
                    for x in (feats, probs, value_t, weight))
    (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(
        jdistill._loss, has_aux=True), static_argnums=2)(params, batch_j,
                                                          cfg_j)
    ts = _port_ts(tdistill.DistillConfig(**KW))
    batch = tuple(torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16 if i == 0 else torch.float32)
                  for i, x in enumerate(batch_j))
    loss, metrics = tdistill._loss(ts.model, batch,
                                   tdistill.DistillConfig(**KW))
    loss.backward()
    assert set(metrics) == set(ref_m)
    for k in metrics:
        assert abs(float(metrics[k].detach()) - float(ref_m[k])) <= \
            3e-3 * abs(float(ref_m[k])), k
    got = params_to_jax({k: p.grad for k, p in ts.model.named_parameters()})
    for layer, leaves in got["params"].items():
        for k, g in leaves.items():
            ref = np.asarray(ref_g["params"][layer][k])
            bound = 0.3 if layer.startswith("Conv") and k == "bias" else 0.03
            assert np.linalg.norm(g - ref) <= bound * np.linalg.norm(ref), \
                (layer, k)


def _expect_az_step(start, run, guided):
    cfg = tdistill.DistillConfig(guided=guided, **KW)
    ts = _port_ts(cfg)
    before = params_to_jax({k: p.detach().clone()
                            for k, p in ts.model.named_parameters()})
    ts2, es, metrics = tdistill.az_train_step(
        ts, _to_port(start), cfg, device="cpu", draws=run["draws"],
        fresh=[to_torch(g, "cpu") for g in run["fresh"]],
        perm=run["perm"])
    assert ts2.update_count == int(run["ts2"].update_count) == \
        int(run["ts"].update_count) + 1
    ref_m = run["metrics"]
    assert set(metrics) == set(ref_m)
    for k in metrics:
        assert abs(float(metrics[k]) - float(ref_m[k])) <= \
            3e-3 * abs(float(ref_m[k])), k
    after = params_to_jax(dict(ts2.model.named_parameters()))
    ref_after = run["ts2"].params["params"]
    for layer, leaves in after["params"].items():
        for k, p in leaves.items():
            d_port = p - before["params"][layer][k]
            d_jax = np.asarray(ref_after[layer][k]) - before["params"][layer][k]
            assert np.linalg.norm(d_port - d_jax) <= \
                0.05 * np.linalg.norm(d_jax), (layer, k)
    assert float(ts2.optimizer.state[ts2.model.dense.weight]["step"]) == \
        int(run["ts2"].opt_state[1][0].count)


def test_az_train_step_matches_jax(start, jax_run):
    _expect_az_step(start, jax_run, False)


def test_guided_az_train_step_matches_jax(start, jax_guided):
    _expect_az_step(start, jax_guided, True)


def test_guided_step_runs_on_its_net():
    """AlphaZero mode on the port alone: net-guided targets on the [-1, 1]
    scale, every visit distribution normalised, the parameters moved."""
    cfg = tdistill.DistillConfig(rollout_len=2, n_sim=3, max_tree_depth=2,
                                 guided=True)
    ts = tdistill.distill_init(0, cfg, "cpu")
    before = [p.detach().clone() for p in ts.model.parameters()]
    es = env_reset(1, 3, device="cpu")
    fin, feats, probs, value_t, weight = tdistill.collect_search_rollout(
        es, cfg, ts.gen, ts.model, device="cpu")
    assert feats.shape[:3] == (2, 3, 4) and probs.shape == (2, 3, 4, 6)
    assert torch.allclose(probs.sum(-1), torch.ones(()))
    assert (value_t.abs() <= 1.0).all()
    assert (fin.game.timestep == 2).all()
    ts2, _, metrics = tdistill.az_train_step(ts, es, cfg, device="cpu")
    assert ts2.update_count == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, ts2.model.parameters()))
    with pytest.raises(ValueError, match="model"):
        tdistill.collect_search_rollout(es, cfg, ts.gen, device="cpu")


def test_train_az_main_resumes_and_saves(tmp_path, capsys):
    """``python -m pomcpp_tpu_torch.train_az`` on the CPU: warm-started
    from the JAX package's checkpoint, one JSON line an iteration with the
    JAX script's rates, a checkpoint that both packages read back."""
    from pomcpp_tpu_torch.train_az import main

    ck = tmp_path / "ck"
    main(["--batch", "2", "--iters", "2", "--rollout", "2", "--sims", "2",
          "--depth", "2", "--tree-depth", "2", "--device", "cpu",
          "--resume", CKPT, "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"warm-started params from {CKPT}"
    rows = [json.loads(line) for line in out[1:]]
    assert [r["iter"] for r in rows] == [0, 1]
    start = int(jax_train_state().update_count)
    assert [r["update"] for r in rows] == [start + 1, start + 2]
    for r in rows:
        # Both rates are rounded to 0.1: their ratio is the search's size.
        assert r["search_steps_per_s"] == pytest.approx(
            r["env_steps_per_s"] * 4 * 2 * (2 + 2), abs=0.05 * 32 + 0.05)
        assert np.isfinite(r["loss"])
    back = jax_restore(str(ck), jax.eval_shape(
        lambda: jdistill.distill_init(jax.random.PRNGKey(0))))
    assert int(back.update_count) == start + 2

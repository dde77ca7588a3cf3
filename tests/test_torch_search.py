"""The port's planners vs ``pomcpp_tpu.search`` on the CPU.

The start: four boards stepped eight random steps (bombs ticking, flames),
with agent 1 dead on board 1 and agents 0 and 2 dead on board 2.  JAX's key
tree cannot be drawn in torch, so each test builds the integers the JAX
planner draws from its key -- ``split(key, B)`` per board for the vmapped
planners, then ``split(k, n_sim)``, ``split(k) -> k_opp, k_play``,
``split(k_opp, max_tree_depth)``, ``randint(., 0, 6)``, as ``search.py``
walks them -- and hands them to the port's ``draws=``.  Tolerances:

* ``playout_value``, ``mcts_moves``, ``_tree_search`` (under a deterministic
  f32 leaf function) and ``mcts_moves_chunk`` (against ``mcts_moves_pallas``
  in interpret mode): bit for bit, moves, root visits and root Q.
* ``lookahead_moves``: the candidate values within 1e-6 (a mean of
  fractions, summed in playout order; measured: equal); the move equal
  wherever the top two values are more than that apart.
* ``mcts_moves_net`` with ``artifacts/ppo_randseat`` (its logits within
  1.6e-5 of JAX's): visits and moves equal, root Q within 1e-4 (measured:
  2.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu import search as jsearch
from pomcpp_tpu.core.board_gen import random_cell_state as jax_random_cell_state
from pomcpp_tpu.learner import ppo as jppo
from pomcpp_tpu.utils import restore_checkpoint as jax_restore
from pomcpp_tpu_torch import search as tsearch
from pomcpp_tpu_torch.convert import params_from_jax, to_numpy, to_torch
from pomcpp_tpu_torch.engine.cellular import cellular_step
from pomcpp_tpu_torch.models.actor_critic import ActorCritic

B = 4
N_SIM, DEPTH, TREE = 4, 3, 3
CKPT = "artifacts/ppo_randseat"


def _randint4(k):
    return jax.random.randint(k, (4,), 0, 6, jnp.int32)


def _np(x):
    return torch.from_numpy(np.array(x))


def tree_draws(key, b, n_sim, tree, depth=None):
    """The draws of the vmapped ``_tree_search`` from ``key``: opponents
    i32[n_sim, tree, b, 4] and (with ``depth``) playouts i32[n_sim, depth,
    b, 4]."""
    def board(kb):
        def sim(k):
            k_opp, k_play = jax.random.split(k)
            opp = jax.vmap(_randint4)(jax.random.split(k_opp, tree))
            play = jax.vmap(_randint4)(jax.random.split(k_play, depth or 1))
            return opp, play
        return jax.vmap(sim)(jax.random.split(kb, n_sim))

    opp, play = jax.vmap(board)(jax.random.split(key, b))
    out = {"opponents": _np(jnp.transpose(opp, (1, 2, 0, 3)))}
    if depth:
        out["playout"] = _np(jnp.transpose(play, (1, 2, 0, 3)))
    return out


def pallas_draws(key, b, n_sim, tree, depth):
    """The draws of ``mcts_moves_pallas`` (batch-level keys)."""
    def sim(k):
        k_sel, k_play = jax.random.split(k)
        opp = jax.vmap(lambda ko: jax.random.randint(ko, (b, 4), 0, 6,
                                                     jnp.int32))(
            jax.random.split(k_sel, tree))
        return opp, jax.random.randint(k_play, (depth, b, 4), 0, 6, jnp.int32)

    opp, play = jax.vmap(sim)(jax.random.split(key, n_sim))
    return {"opponents": _np(opp), "playout": _np(play)}


@pytest.fixture(scope="module")
def boards():
    """(JAX CellState batch, the port's) after eight random plane steps."""
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    cs = to_torch(jax.tree.map(np.asarray,
                               jax.vmap(jax_random_cell_state)(keys)), "cpu")
    rng = np.random.RandomState(4)
    for _ in range(8):
        mv = torch.from_numpy(rng.randint(0, 6, (B, 4)).astype(np.int32))
        cs = cellular_step(cs, torch.where(cs.agent_dead, 0, mv))
    dead = cs.agent_dead.clone()
    dead[1, 1] = True
    dead[2, [0, 2]] = True
    cs = cs._replace(agent_dead=dead,
                     alive_count=(4 - dead.sum(1)).to(torch.int32))
    assert (cs.bomb_timer > 0).any()
    game = to_numpy(cs)
    return jsearch.CellState(*map(jnp.asarray, game)), cs


@pytest.fixture(scope="module")
def ckpt_nets():
    params = jax_restore(CKPT, jax.eval_shape(
        lambda: jppo.ppo_init(jax.random.PRNGKey(0)))).params
    model = ActorCritic()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_from_jax(params).items()})
    return params, model


def _equal(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, what
    assert np.array_equal(ref, got), (what, ref, got)


def test_playout_value_matches_jax(boards):
    cs_j, cs = boards
    key = jax.random.PRNGKey(1)
    run = jax.jit(jax.vmap(lambda c, k, a: jsearch.playout_value(
        c, a, k, DEPTH * 3), in_axes=(0, 0, None)))
    for agent in (0, 3):
        ref = run(cs_j, jax.random.split(key, B), jnp.int32(agent))
        play = jax.vmap(lambda kb: jax.vmap(_randint4)(
            jax.random.split(kb, DEPTH * 3)))(jax.random.split(key, B))
        got = tsearch.playout_value(
            cs, agent, depth=DEPTH * 3,
            draws={"playout": _np(jnp.transpose(play, (1, 0, 2)))},
            device="cpu")
        _equal(ref, got, f"agent {agent}")
    assert np.unique(np.asarray(ref)).size > 1


def test_lookahead_moves_matches_jax(boards):
    cs_j, cs = boards
    key, depth, n_play = jax.random.PRNGKey(2), DEPTH, 4
    mv_j, vals_j = jsearch.lookahead_moves(cs_j, 0, key, depth=depth,
                                           n_playouts=n_play)

    def board(kb):
        def cand(k):
            ko, kp = jax.random.split(k)
            play = jax.vmap(lambda kk: jax.vmap(_randint4)(
                jax.random.split(kk, depth)))(jax.random.split(kp, n_play))
            return _randint4(ko), play
        return jax.vmap(cand)(jax.random.split(kb, 6))

    others, play = jax.vmap(board)(jax.random.split(key, B))
    mv, vals = tsearch.lookahead_moves(
        cs, 0, depth=depth, n_playouts=n_play, device="cpu",
        draws={"others": _np(others),
               "playout": _np(jnp.transpose(play, (3, 0, 1, 2, 4)))})
    vals_j = np.asarray(vals_j)
    assert np.abs(vals_j - vals.numpy()).max() <= 1e-6
    top2 = np.sort(vals_j, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-6
    assert np.array_equal(np.asarray(mv_j)[clear], mv.numpy()[clear])


@pytest.mark.parametrize("agent", [0, 2])
def test_mcts_moves_matches_jax(boards, agent):
    cs_j, cs = boards
    key = jax.random.PRNGKey(3 + agent)
    ref = jsearch.mcts_moves(cs_j, agent, key, n_sim=N_SIM, depth=DEPTH,
                             max_tree_depth=TREE)
    got = tsearch.mcts_moves(cs, agent, n_sim=N_SIM, depth=DEPTH,
                             max_tree_depth=TREE, device="cpu",
                             draws=tree_draws(key, B, N_SIM, TREE, DEPTH))
    for what, r, g in zip(("moves", "visits", "root_q"), ref, got):
        _equal(r, g, what)
    assert int(got[0][2]) == 0           # agent 2 is dead on board 2


def test_tree_search_matches_jax_under_a_fixed_leaf(boards):
    """The tree alone: PUCT on priors and values that a deterministic f32
    function of the leaf state gives, identical on both sides."""
    cs_j, cs = boards
    agent, key, n_sim = 1, jax.random.PRNGKey(5), 8

    def leaf_j(leaf, _k):
        h = (leaf.agent_x[agent] * 7 + leaf.agent_y[agent] * 3
             + jnp.sum(leaf.bomb_timer) + jnp.sum(leaf.agent_dead))
        prior = ((h + jnp.arange(6) * 5) % 7 + 1).astype(jnp.float32) / 16.0
        return prior, (h % 11).astype(jnp.float32) / 11.0 - 0.25

    def leaf_t(leaf, _s):
        h = (leaf.agent_x[:, agent] * 7 + leaf.agent_y[:, agent] * 3
             + leaf.bomb_timer.sum(1) + leaf.agent_dead.sum(1))
        prior = ((h[:, None] + torch.arange(6) * 5) % 7 + 1).float() / 16.0
        return prior, (h % 11).float() / 11.0 - 0.25

    def score_j(nv, q, prior):
        return q + 1.5 * prior * (jnp.sqrt(nv.sum() + 1.0) / (1.0 + nv))

    def score_t(nv, q, prior):
        return q + 1.5 * prior * (torch.sqrt(nv.sum(1, keepdim=True) + 1.0)
                                  / (1.0 + nv))

    root_prior = jnp.full((6,), 1.0 / 6.0, jnp.float32)
    ref = jax.jit(jax.vmap(lambda r, k: jsearch._tree_search(
        r, k, agent, n_sim, TREE, score_j, leaf_j, root_prior)))(
            cs_j, jax.random.split(key, B))
    got = tsearch._tree_search(
        cs, agent, n_sim, TREE, score_t, leaf_t,
        torch.full((B, 6), 1.0 / 6.0),
        tree_draws(key, B, n_sim, TREE)["opponents"])
    for what, r, g in zip(("moves", "visits", "root_q"), ref, got):
        _equal(r, g, what)
    assert (np.asarray(ref[1]).max(1) > 1).any()   # the trees grew


def test_mcts_moves_net_matches_jax(boards, ckpt_nets):
    cs_j, cs = boards
    params, model = ckpt_nets
    agent, key = 3, jax.random.PRNGKey(6)
    ref = jax.jit(lambda b, k: jsearch.mcts_moves_net(
        b, agent, k, jppo._MODEL.apply, params, n_sim=N_SIM,
        max_tree_depth=TREE))(cs_j, key)
    got = tsearch.mcts_moves_net(cs, agent, model, n_sim=N_SIM,
                                 max_tree_depth=TREE, device="cpu",
                                 draws=tree_draws(key, B, N_SIM, TREE))
    _equal(ref[0], got[0], "moves")
    _equal(ref[1], got[1], "visits")
    assert np.abs(np.asarray(ref[2]) - got[2].numpy()).max() <= 1e-4


def test_mcts_moves_chunk_matches_pallas(boards):
    """``mcts_moves_pallas`` with its chunk kernel in interpret mode."""
    cs_j, cs = boards
    agent, key = 0, jax.random.PRNGKey(7)
    ref = jsearch.mcts_moves_pallas(cs_j, agent, key, n_sim=N_SIM,
                                    depth=DEPTH, max_tree_depth=TREE,
                                    interpret=True)
    got = tsearch.mcts_moves_chunk(
        cs, agent, n_sim=N_SIM, depth=DEPTH, max_tree_depth=TREE,
        device="cpu", draws=pallas_draws(key, B, N_SIM, TREE, DEPTH))
    for what, r, g in zip(("moves", "visits", "root_q"), ref, got):
        _equal(r, g, what)


def test_planners_draw_from_their_generator(boards):
    """Without draws a planner takes them from its generator: the same seed
    gives the same search, and a generator or the draws are required."""
    _, cs = boards
    runs = [tsearch.mcts_moves_chunk(cs, 1, torch.Generator().manual_seed(9),
                                     n_sim=3, depth=2, max_tree_depth=2,
                                     device="cpu") for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert int(runs[0][1].sum()) == 3 * B
    with pytest.raises(ValueError, match="generator"):
        tsearch.mcts_moves(cs, 0, n_sim=2, depth=2, max_tree_depth=2,
                           device="cpu")
    with pytest.raises(ValueError, match="draws"):
        tsearch.playout_value(cs, 0, depth=2, device="cpu",
                              draws={"playout": torch.zeros((3, B, 4))})

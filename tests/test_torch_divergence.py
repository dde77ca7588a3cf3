"""The port's divergence classifier and census vs the JAX package's, on the
CPU.

``testing.divergence.divergence_classes`` against the JAX classifier on four
crafted transitions, one per class; ``divergence_census.run_census`` with
injected moves against a JAX loop of ``scripts/divergence_census.py``'s
``census_step`` on the same moves.  Tolerance: exact equality of the class
lists, counts and ppm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import init_state_np
from pomcpp_tpu.core.constants import M_BOMB, M_DOWN, M_IDLE, M_LEFT, M_RIGHT
from pomcpp_tpu.core.state import empty_state, plant_bomb, put_agent
from pomcpp_tpu.engine.cellular import CellState as JCellState
from pomcpp_tpu.engine.cellular import cellular_step as jax_cellular_step
from pomcpp_tpu.engine.cellular import from_state as jax_from_state
from pomcpp_tpu.engine.step import step as jax_step
from pomcpp_tpu.testing.divergence import divergence_classes as jax_classes
from pomcpp_tpu_torch.agents.simple import simple_agent_init
from pomcpp_tpu_torch.agents.simple_cellular import simple_agent_cell_joint
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.core.state import I32, state_of
from pomcpp_tpu_torch.divergence_census import run_census, start_states
from pomcpp_tpu_torch.engine.cellular import board_of, cellular_step, from_state
from pomcpp_tpu_torch.engine.step import step
from pomcpp_tpu_torch.testing.divergence import divergence_classes

GAMES, STEPS = 64, 100
CMP_FIELDS = [f for f in JCellState._fields if f != "timestep"]


@pytest.fixture(scope="module")
def census_step():
    """``scripts/divergence_census.py``'s ``census_step`` with the moves
    given (its random branch draws them in the step)."""
    @jax.jit
    def fn(s, c, mv):
        s2 = jax.vmap(jax_step)(s, mv)
        e2 = jax.vmap(jax_from_state)(s2)
        c2 = jax.vmap(jax_cellular_step)(c, mv)
        eq = jnp.ones(mv.shape[0], bool)
        for f in CMP_FIELDS:
            a, b = getattr(e2, f), getattr(c2, f)
            d = (a != b).reshape(mv.shape[0], -1).any(axis=1) \
                if a.ndim > 1 else (a != b)
            eq = eq & ~d
        return s2, c2, eq, s.alive_count > 1
    return fn


def _one(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def _crafted():
    """(state, moves) for classes 1-4, in order."""
    base = empty_state()
    for a, (x, y) in enumerate([(5, 5), (0, 0), (10, 10), (0, 10)]):
        base = put_agent(base, x, y, a)
    # 1: agent 0 stands on its bomb and plants again (max 2 bombs).
    s1 = base._replace(agent_max_bombs=base.agent_max_bombs.at[0].set(2))
    s1 = plant_bomb(s1, 5, 5, 0, life=7)
    # 2: the next free bomb slot holds a stale direction.
    s2 = plant_bomb(base, 8, 8, 1, set_item=True, life=6)
    s2 = s2._replace(bombs=s2.bombs._replace(
        dir=s2.bombs.dir.at[1].set(M_RIGHT)))
    # 3: two bombs in each other's range explode on this step.
    s3 = plant_bomb(base, 3, 3, 1, set_item=True, life=1)
    s3 = plant_bomb(s3, 4, 3, 2, set_item=True, life=1)
    # 4: two bombs slide this step.
    s4 = plant_bomb(base, 2, 7, 1, set_item=True, life=8)
    s4 = plant_bomb(s4, 7, 2, 2, set_item=True, life=8)
    s4 = s4._replace(bombs=s4.bombs._replace(
        dir=s4.bombs.dir.at[0].set(M_RIGHT).at[1].set(M_DOWN)))
    return [(s1, [M_BOMB, M_IDLE, M_IDLE, M_IDLE]),
            (s2, [M_BOMB, M_IDLE, M_IDLE, M_IDLE]),
            (s3, [M_LEFT, M_IDLE, M_IDLE, M_IDLE]),
            (s4, [M_IDLE] * 4)]


def test_divergence_classes_match_jax_on_each_class(census_step):
    cases = _crafted()
    pre = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[cases[k % 4][0] for k in range(GAMES)])
    mv = np.array([cases[k % 4][1] for k in range(GAMES)], np.int32)
    post, _, eq, _ = census_step(pre, jax.vmap(jax_from_state)(pre),
                                 jnp.asarray(mv))
    pre_t = state_to_torch(pre, "cpu")
    post_t = step(pre_t, torch.from_numpy(mv))
    pre_c, post_c = from_state(pre_t), from_state(post_t)
    for k, name in enumerate(["1:stacked-plant", "2:stale-plant-direction",
                              "3:multi-bomb-chain", "4:multi-bomb-pileup"]):
        ref = jax_classes(jax_from_state(_one(pre, k)), mv[k],
                          jax_from_state(_one(post, k)),
                          pre_exact=_one(pre, k))
        got = divergence_classes(board_of(pre_c, k), torch.from_numpy(mv[k]),
                                 board_of(post_c, k),
                                 pre_exact=state_of(pre_t, k))
        assert got == ref and name in got, (k, got, ref)
    # The stacked plant and the stale direction diverge on their step (the
    # chain and the pileup here resolve alike in both engines).
    assert not np.asarray(eq)[[0, 1]].any()


def _simple_moves():
    """SimpleAgent moves on the plane trajectories of the census's start
    boards: what the census's simple policy plays on synced boards, as
    fixed arrays both censuses replay."""
    _, c = start_states(range(GAMES), "cpu")
    ps = simple_agent_init((GAMES, 4), "cpu")
    gen = torch.Generator().manual_seed(5)
    moves = []
    for _ in range(STEPS):
        rands = torch.randint(0, 5, (GAMES, 4), generator=gen, dtype=I32)
        mv, _, ps = simple_agent_cell_joint(c, ps, rands)
        mv = torch.where(c.agent_dead, 0, mv).to(I32)
        moves.append(mv)
        c = cellular_step(c, mv)
    return torch.stack(moves).numpy()


def _jax_census(census_step, moves):
    """The script's loop (first-divergence freeze, classification) with the
    moves given."""
    s = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[init_state_np(g) for g in range(GAMES)])
    kick = jnp.asarray([(g % 2) == 1 for g in range(GAMES)])
    s = s._replace(agent_can_kick=jnp.broadcast_to(kick[:, None], (GAMES, 4)))
    c = jax.vmap(jax_from_state)(s)
    counts = {"1:stacked-plant": 0, "2:stale-plant-direction": 0,
              "3:multi-bomb-chain": 0, "4:multi-bomb-pileup": 0}
    multi = unclassified = live_steps = first_div = 0
    synced = np.ones(GAMES, bool)
    for t in range(STEPS):
        s_pre = s
        s, c, eq, live = census_step(s, c, jnp.asarray(moves[t]))
        live = np.asarray(live)
        neq = np.asarray(~eq) & live & synced
        live_steps += int((live & synced).sum())
        for i in np.nonzero(neq)[0]:
            first_div += 1
            synced[i] = False
            cl = jax_classes(jax_from_state(_one(s_pre, i)), moves[t][i],
                             jax_from_state(_one(s, i)),
                             pre_exact=_one(s_pre, i))
            unclassified += not cl
            multi += len(cl) > 1
            for name in cl:
                counts[name] += 1
        if not (live & synced).any():
            break
    return {"synced_live_board_steps": live_steps,
            "first_divergences": first_div,
            "divergence_ppm": round(1e6 * first_div / max(live_steps, 1), 2),
            "class_counts": counts, "multi_class_steps": multi,
            "unclassified": unclassified}


def test_census_with_moves_matches_the_jax_loop(census_step):
    """64 games x 100 steps of SimpleAgent moves: counts, ppm and per-class
    counts equal the JAX loop's."""
    moves = _simple_moves()
    ref = _jax_census(census_step, moves)
    got = run_census(GAMES, STEPS, batch=GAMES, seed=0, device="cpu",
                     moves=torch.from_numpy(moves), log=lambda m: None)
    assert {k: got[k] for k in ref} == ref
    assert ref["first_divergences"] >= 2 and ref["unclassified"] == 0

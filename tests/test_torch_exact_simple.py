"""The port's exact SimpleAgent and strategy toolkit vs the JAX package's,
on the CPU.

States come from SimpleAgent self-play on the exact engine (JAX side), from
8 reference boards, half with kick; the rands are drawn from numpy and
injected on both sides.  Tolerance: exact equality of moves, ``consumed``,
every ``SimpleAgentState`` field, the BFS map (distances, predecessors,
source, info bit), the danger map and every move selector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.agents.simple import simple_agent_act as jax_act
from pomcpp_tpu.agents.simple import simple_agent_init as jax_init
from pomcpp_tpu.core.board_gen import init_state_np
from pomcpp_tpu.engine.step import step as jax_step
from pomcpp_tpu.strategy import moves as jm
from pomcpp_tpu.strategy import rmap as jr
from pomcpp_tpu_torch.agents.simple import (
    SimpleAgentState,
    simple_agent_act,
    simple_agent_init_batch,
    simple_agent_joint,
)
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.strategy import moves as tm
from pomcpp_tpu_torch.strategy.rmap import fill_rmap, is_reachable

B, ACTS = 8, 40


@pytest.fixture(scope="module")
def play():
    """JAX self-play: per act the states, rands, agent states and JAX
    results (moves, consumed, agent states after)."""
    act = jax.jit(jax.vmap(jax_act, in_axes=(0, None, 0, 0)))
    step = jax.jit(jax.vmap(jax_step))
    s = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[init_state_np(seed) for seed in range(B)])
    kick = np.arange(B) % 2 == 1
    s = s._replace(agent_can_kick=jnp.asarray(np.repeat(kick[:, None], 4, 1)))
    asts = [jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                         jax_init()) for _ in range(4)]
    rands = np.random.default_rng(3).integers(0, 5, (ACTS, B, 4)).astype(
        np.int32)
    rows = []
    for t in range(ACTS):
        out = [act(s, jnp.int32(a), asts[a], jnp.asarray(rands[t, :, a]))
               for a in range(4)]
        rows.append((s, asts, out))
        mv = jnp.stack([o[0] for o in out], 1)
        mv = jnp.where(s.agent_dead, 0, mv)
        asts = [o[2] for o in out]
        s = step(s, mv)
    return rows, rands


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b), what


def _ast_to_torch(ast):
    return SimpleAgentState(*(torch.from_numpy(np.asarray(x).astype(
        np.int32)) for x in ast))


def test_simple_agent_act_matches_jax(play):
    """8 boards x 40 acts of the four agents (``simple_agent_joint``):
    moves, consumed and the agent state after each act; the one-agent form
    equals the joint one."""
    rows, rands = play
    in_danger = fled = 0
    for t, (s, asts, out) in enumerate(rows):
        ts = state_to_torch(s, "cpu")
        joint = SimpleAgentState(*(torch.stack(
            [_ast_to_torch(asts[a])[k] for a in range(4)], 1)
            for k in range(5)))
        mv, cons, after = simple_agent_joint(ts, joint,
                                             torch.from_numpy(rands[t]))
        for a in range(4):
            what = f"act {t} agent {a}"
            _eq(out[a][0], mv[:, a], f"{what}: move")
            _eq(out[a][1], cons[:, a], f"{what}: consumed")
            for k, x in enumerate(out[a][2]):
                _eq(x, after[k][:, a], f"{what}: state field {k}")
            if t % 10 == 0:   # the one-agent form with an int agent id
                move, consumed, ast2 = simple_agent_act(
                    ts, a, _ast_to_torch(asts[a]),
                    torch.from_numpy(rands[t, :, a]))
                assert torch.equal(move, mv[:, a]), what
                assert torch.equal(consumed, cons[:, a]), what
                assert all(torch.equal(x, y[:, a])
                           for x, y in zip(ast2, after)), what
        d = np.asarray(jax.vmap(jm.danger_map)(s))
        cells = np.asarray(s.agent_x) + 11 * np.asarray(s.agent_y)
        danger = np.take_along_axis(d, cells, 1) > 0
        in_danger += int(danger.sum())
        fled += int((danger & (mv.numpy() != 0)).sum())
    assert in_danger > 20 and fled > 10


def test_toolkit_matches_jax(play):
    """fill_rmap for all four agents, the danger map, safe directions, the
    move selectors and the adjacency scans on 64 mid-game boards."""
    rows, _ = play
    s = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                     *[rows[t][0] for t in range(5, ACTS, 5)])
    ts = state_to_torch(s, "cpu")
    _eq(jax.vmap(jm.danger_map)(s), tm.danger_map(ts), "danger_map")
    radius = np.arange(s.board.shape[0], dtype=np.int32) % 9
    for a in range(4):
        r = jax.vmap(jr.fill_rmap, in_axes=(0, None))(s, a)
        got = fill_rmap(ts, a)
        for k, (x, y) in enumerate(zip(r, got)):
            _eq(x, y, f"fill_rmap agent {a} field {k}")
        cell = (np.arange(s.board.shape[0]) * 37 + a) % 121
        _eq(jax.vmap(jr.is_reachable)(r, cell),
            is_reachable(got, torch.from_numpy(cell)), "is_reachable")
        for name, fn, extra in (
                ("safe_place", tm.move_towards_safe_place, radius),
                ("powerup", tm.move_towards_powerup, 6),
                ("enemy", tm.move_towards_enemy, 7)):
            jfn = getattr(jm, f"move_towards_{name}")
            ref = jax.vmap(jfn, in_axes=(0, 0, 0 if name == "safe_place"
                                         else None))(s, r, extra)
            _eq(ref, fn(ts, got, torch.as_tensor(extra)), f"{name} {a}")
        ref = jax.vmap(jm.move_towards_position)(r, cell)
        _eq(ref, tm.move_towards_position(got, torch.from_numpy(cell)),
            f"move_towards_position {a}")
        x, y = ts.agent_x[:, a], ts.agent_y[:, a]
        jmv, jc = jax.vmap(jm.safe_directions)(s, s.agent_x[:, a],
                                               s.agent_y[:, a])
        tmv, tc = tm.safe_directions(ts, x, y)
        _eq(jmv, tmv, "safe_directions")
        _eq(jc, tc, "safe_directions count")
        _eq(jax.vmap(jm.is_in_danger)(s, s.agent_x[:, a], s.agent_y[:, a]),
            tm.is_in_danger(ts, x, y), "is_in_danger")
        for dist in (1, 7):
            _eq(jax.vmap(jm.is_adjacent_enemy, in_axes=(0, None, None))(
                s, a, dist), tm.is_adjacent_enemy(ts, a, dist), "enemy")
            _eq(jax.vmap(jm.is_adjacent_item, in_axes=(0, None, None, None))(
                s, a, dist, 2), tm.is_adjacent_item(ts, a, dist, 2), "wood")


def test_simple_agent_init_batch_and_policy():
    asts = simple_agent_init_batch(3, "cpu")
    assert all(t.shape[:2] == (3, 4) for t in asts)
    from pomcpp_tpu_torch.agents.simple import simple_agent_policy
    from pomcpp_tpu_torch.core.board_gen import init_states_np

    s = init_states_np(range(3), device="cpu")
    gen = torch.Generator().manual_seed(0)
    one = SimpleAgentState(*(t[:, 1] for t in asts))
    move, ast2 = simple_agent_policy(gen, s, 1, one)
    assert move.shape == (3,) and ast2.rp_count.tolist() == [1, 1, 1]

"""The port's exact conformance engine vs the JAX package's, on the CPU.

``engine.step.step`` (and the queue, flame and generator modules under it)
against ``jax.jit(jax.vmap(...))`` of the JAX functions on the same states
and moves.  Tolerance: exact equality of every ``State`` field, every
PHYSICAL queue slot included (stale slots are observable: a recycled slot
leaks its direction into a fresh plant).  Every batch is padded to
``B = 32`` boards so that the vmapped JAX step compiles once.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core import queue as jq
from pomcpp_tpu.core import rng as jrng
from pomcpp_tpu.core.board_gen import init_state_np
from pomcpp_tpu.core.constants import (
    BOMB_LIFETIME,
    C_FLAME,
    C_RIGID,
    C_WOOD,
    M_BOMB,
    M_DOWN,
    M_IDLE,
    M_LEFT,
    M_RIGHT,
    M_UP,
    MAX_BOMBS_PER_AGENT,
)
from pomcpp_tpu.core.state import (
    empty_state,
    kill_many,
    plant_bomb,
    put_agent,
    put_agents_in_corners,
    put_item,
    set_bomb_field,
)
from pomcpp_tpu.engine.flames import explode_top_bomb as jax_explode_top_bomb
from pomcpp_tpu.engine.flames import spawn_flame as jax_spawn_flame
from pomcpp_tpu.engine.flames import tick_bombs as jax_tick_bombs
from pomcpp_tpu.engine.step import step as jax_step
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.core import queue as q
from pomcpp_tpu_torch.core import rng
from pomcpp_tpu_torch.core.board_gen import init_states_np
from pomcpp_tpu_torch.core.state import Bombs, state_of
from pomcpp_tpu_torch.engine.flames import (
    explode_top_bomb,
    spawn_flame,
    tick_bombs,
)
from pomcpp_tpu_torch.engine.step import step

B = 32


@pytest.fixture(scope="module")
def jstep():
    return jax.jit(jax.vmap(jax_step))


def _stack(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _pad(states):
    """The one-board JAX states, repeated up to ``B`` boards."""
    return _stack([states[k % len(states)] for k in range(B)])


def _leaves(s):
    for name in s._fields:
        v = getattr(s, name)
        if name in ("bombs", "flames"):
            for sub in v._fields:
                yield f"{name}.{sub}", getattr(v, sub)
        else:
            yield name, v


def assert_same(js, ts, what=""):
    """Every field of the JAX batch ``js`` equals the port's ``ts``."""
    bad = []
    for (name, a), (_, b) in zip(_leaves(js), _leaves(ts)):
        a = np.asarray(a)
        b = b.cpu().numpy()
        if a.shape != b.shape or not np.array_equal(a.astype(b.dtype), b):
            boards = sorted({int(i) for i in np.nonzero(
                (a != b).reshape(a.shape[0], -1).any(1))[0]})
            bad.append(f"{name} (boards {boards[:6]})")
    assert not bad, f"{what}: fields differ: {bad}"


def run_both(jstep, js, moves):
    """Step both engines over ``moves`` ([T, B, 4]), equal after each step."""
    ts = state_to_torch(js, "cpu")
    for t, mv in enumerate(moves):
        mv = np.asarray(mv, np.int32)
        js = jstep(js, jnp.asarray(mv))
        ts = step(ts, torch.from_numpy(mv))
        assert_same(js, ts, f"step {t}")
    return js, ts


# --- Host RNG and the reference's board generator ------------------------


def test_mt19937_64_and_uniform_int_match_jax():
    for seed in (5489, 0, 0x1337, 2 ** 64 - 1):
        a, b = jrng.MT19937_64(seed), rng.MT19937_64(seed)
        assert [a() for _ in range(2000)] == [b() for _ in range(2000)]
    for lo, hi in ((0, 6), (1, 4), (0, 37), (0, 0)):
        a, b = jrng.MT19937_64(7), rng.MT19937_64(7)
        da, db = jrng.UniformIntDistribution(lo, hi), \
            rng.UniformIntDistribution(lo, hi)
        assert [da(a) for _ in range(500)] == [db(b) for _ in range(500)]


def test_init_state_np_matches_jax_for_64_seeds():
    seeds = list(range(60)) + [0x1337, 12345, 2 ** 31, 2 ** 40 + 3]
    got = init_states_np(seeds, device="cpu")
    assert_same(_stack([init_state_np(s) for s in seeds]), got,
                "init_states_np")
    one = init_states_np([0x1337], 3, 2, 1, 0, device="cpu")
    assert_same(_stack([init_state_np(0x1337, 3, 2, 1, 0)]), one, "seats")


# --- Queue operations with wrapped heads ---------------------------------


def _queue_inputs(seed):
    r = np.random.default_rng(seed)
    fields = Bombs(*(r.integers(0, 9, (B, 20)).astype(np.int32)
                     for _ in range(6)),
                   r.integers(0, 2, (B, 20)).astype(bool))
    head = r.integers(0, 20, B).astype(np.int32)
    count = r.integers(0, 21, B).astype(np.int32)
    i = np.minimum(r.integers(-1, 20, B), np.maximum(count - 1, 0))
    return fields, head, count, i.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_ops_match_jax(seed):
    fields, head, count, i = _queue_inputs(seed)
    tf = Bombs(*map(torch.from_numpy, fields))
    th, tc, ti = map(torch.from_numpy, (head, count, i))
    jf = jax.tree.map(jnp.asarray, fields)
    val = np.arange(B, dtype=np.int32) + 100

    def eq(a, b):
        assert np.array_equal(np.asarray(a), b.numpy())

    eq(jax.vmap(jq.get)(jf.x, head, i), q.get(tf.x, th, ti))
    eq(jax.vmap(jq.set_)(jf.y, head, i, val),
       q.set_(tf.y, th, ti, torch.from_numpy(val)))
    eq(jax.vmap(jq.logical_view)(jf.dir, head),
       q.logical_view(tf.dir, th))
    for a, b in zip(jq.pop_front(head, count, 20),
                    q.pop_front(th, tc, 20)):
        eq(a, b)
    jr = jax.vmap(lambda f, h, c, k: jq.remove_at(f, h, c, k, 20))(
        jf, head, count, i)
    tr = q.remove_at(tf, th, tc, ti, 20)
    for a, b in zip(jax.tree.leaves(jr), [*tr[0], tr[1], tr[2]]):
        eq(a, b)
    values = Bombs(val, val + 1, val + 2, val + 3, val + 4, None, None)
    ja = jax.vmap(lambda f, v, h, c: jq.append(f, v, h, c, 20),
                  in_axes=(0, Bombs(0, 0, 0, 0, 0, None, None), 0, 0))(
        jf, values, head, count)
    ta = q.append(tf, Bombs(*(None if v is None else torch.from_numpy(v)
                              for v in values)), th, tc, 20)
    for a, b in zip(jax.tree.leaves(ja), [*ta[0], ta[1], ta[2]]):
        eq(a, b)
    # The masked forms leave the boards outside the mask as they were.
    mask = torch.arange(B) % 3 == 0
    got = q.remove_at(tf, th, tc, ti, 20, mask)
    for a, b, f in zip(tr[0], got[0], tf):
        assert torch.equal(torch.where(mask[:, None], a, f), b)


# --- Scenario states (the JAX suites' constructions) ---------------------


def _kick_base():
    s = empty_state()
    s = put_agent(s, 0, 1, 0)
    s = s._replace(agent_can_kick=s.agent_can_kick.at[0].set(True))
    s = plant_bomb(s, 1, 1, 0, set_item=True)
    return s._replace(
        agent_max_bombs=s.agent_max_bombs.at[0].set(MAX_BOMBS_PER_AGENT))


def _four(*xy):
    s = empty_state()
    for a, (x, y) in enumerate(xy):
        s = put_agent(s, x, y, a)
    return s


def _with(s, **kw):
    for k, (a, v) in kw.items():
        s = s._replace(**{k: getattr(s, k).at[a].set(v)})
    return s


def scenarios():
    """(state, moves) pairs: tests/test_cellular.py:67-196 and the bomb,
    kick and chain cases of tests/test_board_logic.py."""
    I = M_IDLE  # noqa: E741
    out = []
    s = _four((0, 0), (5, 5), (10, 10), (3, 7))
    s = put_item(put_item(s, 6, 5, C_RIGID), 5, 6, C_WOOD)
    out.append((s, [[M_DOWN, M_RIGHT, M_UP, M_LEFT],
                    [M_RIGHT, M_DOWN, M_LEFT, M_UP],
                    [I, M_LEFT, M_DOWN, M_RIGHT]]))
    out.append((_four((4, 5), (6, 5), (0, 0), (10, 10)),
                [[M_RIGHT, M_LEFT, I, I]] * 2))
    out.append((_four((4, 5), (5, 5), (0, 0), (10, 10)),
                [[M_RIGHT, M_LEFT, I, I]]))
    out.append((_four((2, 5), (3, 5), (4, 5), (10, 10)),
                [[M_RIGHT, M_RIGHT, M_RIGHT, I]]))
    out.append((_four((5, 5), (6, 5), (6, 6), (5, 6)),
                [[M_RIGHT, M_DOWN, M_LEFT, M_UP]] * 3))
    out.append((_four((0, 0), (5, 5), (10, 10), (0, 10)),
                [[M_BOMB, I, I, I], [M_RIGHT, I, I, I]] + [[I] * 4] * 14))
    s = put_item(_four((0, 0), (10, 0), (10, 10), (0, 10)), 1, 0, C_WOOD)
    s = s._replace(hidden_pow=s.hidden_pow.at[1].set(1))
    out.append((s, [[M_BOMB, I, I, I], [M_DOWN, I, I, I]] + [[I] * 4] * 14))
    s = _with(_four((0, 0), (4, 0), (10, 10), (0, 10)), agent_strength=(0, 4))
    s = plant_bomb(s, 2, 0, 0, set_item=True, life=3)
    s = plant_bomb(s, 3, 0, 1, set_item=True, life=9)
    out.append((s, [[I] * 4] * 10))
    s = _with(_four((2, 5), (0, 0), (10, 10), (0, 10)),
              agent_can_kick=(0, True))
    s = plant_bomb(s, 3, 5, 1, set_item=True, life=9)
    out.append((s, [[M_RIGHT, I, I, I]] + [[I] * 4] * 8))
    out.append((put_item(s, 4, 5, C_RIGID), [[M_RIGHT, I, I, I], [I] * 4]))
    s = plant_bomb(_four((2, 5), (0, 0), (10, 10), (0, 10)), 3, 5, 1,
                   set_item=True, life=9)
    out.append((s, [[M_RIGHT, I, I, I], [I] * 4]))
    s = jax_spawn_flame(_four((0, 0), (3, 0), (10, 10), (0, 10)), 1, 1, 1)
    out.append((s, [[M_DOWN, I, I, I], [I] * 4]))
    # tests/test_board_logic.py
    out.append((_four((0, 0), (1, 0), (2, 0), (3, 0)),
                [[M_RIGHT, M_RIGHT, M_RIGHT, M_BOMB], [I, I, I, M_RIGHT]]))
    out.append((_four((0, 0), (1, 0), (1, 1), (0, 1)),
                [[M_BOMB] * 4, [M_RIGHT, M_DOWN, M_LEFT, M_UP]]))
    s = put_agent(kill_many(empty_state(), 2, 3), 5, 5, 0)
    s = put_item(put_agent(s, 4, 5, 1), 6, 5, C_WOOD)
    out.append((s, [[M_BOMB, I, I, I]] + [[M_UP, I, I, I]] * BOMB_LIFETIME))
    s = put_agent(kill_many(empty_state(), 2, 3), 5, 5, 0)
    s = _with(put_item(put_item(s, 7, 5, C_WOOD), 8, 5, C_WOOD),
              agent_strength=(0, 5))
    out.append((plant_bomb(s, 6, 5, 0, set_item=True),
                [[I] * 4] * BOMB_LIFETIME))
    s = put_agents_in_corners(empty_state(), 0, 1, 2, 3)
    s = plant_bomb(s, 5, 5, 0, set_item=True)
    s = plant_bomb(s, 4, 5, 1, set_item=True, life=BOMB_LIFETIME - 1)
    out.append((s, [[I] * 4] * BOMB_LIFETIME))
    s = kill_many(_four((5, 5), (4, 5)), 2, 3)
    out.append((s, [[M_BOMB, I, I, I], [I, M_BOMB, I, I]]
                + [[M_DOWN, M_DOWN, I, I]] * (BOMB_LIFETIME - 1)))
    s = kill_many(_kick_base(), 1, 2, 3)
    out.append((s, [[M_RIGHT, I, I, I]] + [[I] * 4] * 4))
    out.append((put_item(s, 5, 1, C_FLAME), [[M_RIGHT, I, I, I]]
                + [[I] * 4] * 3))
    s2 = set_bomb_field(plant_bomb(s, 7, 7, 0, set_item=True), 1, "dir", M_UP)
    out.append((s2, [[M_RIGHT, I, I, I]] + [[I] * 4] * 5))
    s2 = plant_bomb(s, 7, 6, 0, set_item=True)
    s2 = set_bomb_field(put_item(s2, 7, 0, C_WOOD), 1, "dir", M_UP)
    out.append((s2, [[M_RIGHT, I, I, I]] + [[I] * 4] * 6))
    s = put_agent(kill_many(_kick_base(), 2, 3), 0, 2, 1)
    s2 = set_bomb_field(plant_bomb(s, 2, 2, 0, set_item=True), 1, "dir", M_UP)
    out.append((s2, [[M_RIGHT, M_UP, I, I]]))
    s2 = plant_bomb(plant_bomb(s, 2, 2, 0, set_item=True), 0, 3, 0,
                    set_item=True)
    s2 = set_bomb_field(set_bomb_field(s2, 1, "dir", M_UP), 2, "dir", M_UP)
    out.append((s2, [[M_RIGHT, M_UP, I, I]]))
    s = put_agent(put_agent(kill_many(_kick_base(), 3), 0, 2, 1), 1, 3, 2)
    s = plant_bomb(put_item(s, 2, 1, C_RIGID), 0, 3, 0, set_item=True)
    s = set_bomb_field(s, 1, "dir", M_UP)
    out.append((s, [[M_RIGHT, M_UP, M_BOMB, I]] + [[I, I, M_LEFT, I]] * 2))
    s = put_agent(kill_many(_kick_base(), 1, 3), 1, 3, 2)
    s = _with(put_item(s, 2, 1, C_RIGID), agent_can_kick=(2, True))
    out.append((plant_bomb(s, 0, 3, 0, set_item=True), [[I, I, M_LEFT, I]]))
    # A recycled bomb slot leaks its direction into a fresh plant: the
    # next free slot (head + count) holds a stale RIGHT.
    s = plant_bomb(_four((5, 5), (0, 0), (10, 10), (0, 10)), 8, 8, 1,
                   set_item=True, life=6)
    s = s._replace(bombs=s.bombs._replace(dir=s.bombs.dir.at[1].set(M_RIGHT)))
    out.append((s, [[M_BOMB, I, I, I], [M_UP, I, I, I]] + [[I] * 4] * 3))
    s = put_agent(put_agent(put_agent(_kick_base(), 6, 3, 0), 6, 4, 1), 6, 5, 2)
    s = plant_bomb(plant_bomb(s, 5, 6, 3, set_item=True), 6, 6, 2,
                   set_item=True)
    out.append((put_agent(s, 6, 6, 3), [[I] * 4, [I, I, I, M_LEFT]]))
    return out


def test_scenarios_step_like_jax(jstep):
    """Every scenario, all of them in one batch, each step held."""
    sc = scenarios()
    assert len(sc) <= B
    t_max = max(len(m) for _, m in sc)
    moves = np.zeros((t_max, B, 4), np.int32)
    for k, (_, mv) in enumerate(sc):
        moves[:len(mv), k] = mv
    run_both(jstep, _pad([s for s, _ in sc] + [sc[0][0]] * (B - len(sc))),
             moves)


def _chained_states():
    """Boards with chained, stacked and covered bombs about to explode."""
    out = []
    for k in range(8):
        s = put_agents_in_corners(empty_state(), 0, 1, 2, 3)
        s = _with(s, agent_strength=(k % 4, 1 + k % 5))
        s = put_item(put_item(s, 5 + k % 3, 2, C_WOOD), 2, 5 + k % 4, C_RIGID)
        for j, (x, y) in enumerate([(5, 5), (5 + (k % 3), 5), (5, 7),
                                    (3, 5), (5, 5)][: 2 + k % 4]):
            s = plant_bomb(s, x, y, j % 4, set_item=True, life=1 + (j * k) % 2)
        if k % 2:
            s = put_agent(s, 5, 7, 2)
        out.append(s)
    return out


def test_spawn_flame_and_tick_bombs_on_chains():
    states = _chained_states()
    js = _pad(states)
    ts = state_to_torch(js, "cpu")
    xs = np.array([5, 3, 0, 10, 5, 7, 1, 9] * 4, np.int32)
    ys = np.array([5, 5, 0, 10, 4, 5, 9, 1] * 4, np.int32)
    st = np.array([1, 2, 3, 4, 5, 6, 2, 3] * 4, np.int32)
    got = spawn_flame(ts, torch.from_numpy(xs), torch.from_numpy(ys),
                      torch.from_numpy(st))
    assert_same(jax.jit(jax.vmap(jax_spawn_flame))(js, xs, ys, st), got,
                "spawn_flame")
    assert_same(jax.jit(jax.vmap(jax_tick_bombs))(js), tick_bombs(ts),
                "tick_bombs")
    assert_same(jax.jit(jax.vmap(jax_explode_top_bomb))(js),
                explode_top_bomb(ts), "explode_top_bomb")


def _sweep_states():
    """The kick-heavy state (moving bombs) and a 2x2 ring over bombs and a
    flame, both with kick."""
    s = _four((4, 5), (6, 5), (5, 4), (5, 6))
    s = s._replace(agent_can_kick=jnp.ones((4,), bool))
    s = plant_bomb(s, 5, 5, 0, set_item=True, life=6)
    kick = plant_bomb(s, 3, 5, 1, set_item=True, life=9)
    r = _four((5, 5), (6, 5), (6, 6), (5, 6))
    r = r._replace(agent_can_kick=jnp.ones((4,), bool))
    r = plant_bomb(plant_bomb(r, 6, 6, 2, life=2), 5, 5, 0, life=7)
    r = set_bomb_field(plant_bomb(r, 7, 5, 3, set_item=True, life=5), 2,
                       "dir", M_LEFT)
    ring = put_item(r, 5, 4, C_FLAME)
    return kick, ring


def test_every_joint_move_on_two_crafted_states(jstep):
    """6^4 joint moves, one step each, in batches of B."""
    all_moves = np.array(list(itertools.product(range(6), repeat=4)),
                         np.int32)
    all_moves = np.concatenate([all_moves, all_moves[:-len(all_moves) % B]])
    for base in _sweep_states():
        js0 = _pad([base])
        ts0 = state_to_torch(js0, "cpu")
        for k in range(0, len(all_moves), B):
            mv = all_moves[k:k + B]
            assert_same(jstep(js0, jnp.asarray(mv)),
                        step(ts0, torch.from_numpy(mv)), f"moves {k}")


def test_random_play_matches_jax(jstep):
    """32 reference boards (half with kick) x 120 random steps: the 20-slot
    bomb queue wraps."""
    js = _stack([init_state_np(s) for s in range(B)])
    kick = jnp.asarray(np.arange(B) % 2 == 1)
    js = js._replace(agent_can_kick=jnp.broadcast_to(kick[:, None], (B, 4)))
    moves = np.random.default_rng(0).integers(0, 6, (120, B, 4))
    _, ts = run_both(jstep, js, moves)
    heads = ts.bomb_head.numpy()
    assert heads.max() > 0 and (ts.flame_head > 0).any()
    one = state_of(ts, 3)
    assert one.board.shape == (121,) and one.bombs.x.shape == (20,)

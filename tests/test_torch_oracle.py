"""The port's exact step on the oracle suites' scenarios: against the
compiled C++ reference where it builds, and against JAX on the CPU always.

(a) Against the oracle (``testing.oracle``), skipped when
``ensure_oracle()`` is None, as the JAX suites skip: the counterparts of
``test_parity.py``, ``test_exhaustive_2step.py``,
``test_exhaustive_3agent.py``, ``test_exhaustive_moves.py``,
``test_simple_agent.py``'s game parity and ``test_soak.py``.  Every sweep
is ONE batched call of the port's exact step over all its sequences.

(b) Against JAX, always run: the JAX suites' own states (built with
``tests/helpers.py``, converted with ``convert.state_to_torch``), the
port's exact step against ``jax.vmap`` of JAX's ``step`` on:

* the six two-step scenarios of ``test_exhaustive_2step.py``, all 36 x 36
  joint moves of their two agents (7,776 sequences, one port call);
* the three three-agent scenarios of ``test_exhaustive_3agent.py``, all
  125 x 125 at n = 5 (46,875, one port call);
* the three randomized snapshots of ``test_soak.py`` (seeds 120, 147, 176
  at step 35): the port's ``state_fuzz`` snapshot field for field against
  JAX's, then its sweep at n = 5 (46,875, one port call) -- through
  ``state_fuzz.fuzz_one`` with JAX's sweep as the ``reference``, and field
  for field.

JAX's side computes every sequence once and only once per distinct input
(``_jax_two_steps``): the same function of the same inputs, at about half
the reference's cost.

Tolerance: exact equality of every ``State`` field, every physical queue
slot included, and of every oracle dump.
"""

import copy
import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_exhaustive_2step as two_step
import test_exhaustive_3agent as three_agent
from pomcpp_tpu.core.board_gen import init_state_np as jax_init_state_np
from pomcpp_tpu.engine.step import step as jax_step
from pomcpp_tpu_torch import state_fuzz
from pomcpp_tpu_torch.agents.simple import simple_agent_act, simple_agent_init
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.core.board_gen import (
    init_board_items_raw,
    init_state_np,
    init_states_np,
)
from pomcpp_tpu_torch.core.rng import MT19937_64, UniformIntDistribution
from pomcpp_tpu_torch.core.state import map_state, state_of
from pomcpp_tpu_torch.engine.step import step
from pomcpp_tpu_torch.testing import oracle as orc
from test_torch_exact_step import assert_same

needs_oracle = pytest.mark.skipif(orc.ensure_oracle() is None,
                                  reason="reference oracle not buildable")

BOARD_SEEDS = [0x1337, 0x13327] + list(range(200))
TRAJ_SEEDS = [0x1337, 0x13327, 0, 1, 2, 3, 4, 5, 6, 7]
SIMPLE_SEEDS = [0x1337, 0x13327, 1, 2, 3, 4, 5]
SOAK_TRAJ_SEEDS = list(range(100, 200))
SOAK_SIMPLE_SEEDS = [0x51337 + 13 * i for i in range(25)]
SNAPSHOTS = [(120, 35), (147, 35), (176, 35)]
TWO = list(two_step._scenarios())
JAX_STEP = jax.jit(jax_step)
THREE = list(three_agent._scenarios())


def _port(js):
    """A JAX one-board State as a port batch of one, on the CPU."""
    return state_to_torch(jax.tree.map(lambda x: np.asarray(x)[None], js),
                          "cpu")


def _held(ref_dumps, out, what):
    """Every board of the port's ``out`` against the oracle's dumps."""
    mine = orc.states_to_dumps(out)
    bad = [(k, d[:3]) for k in range(len(mine))
           if (d := orc.diff_dumps(ref_dumps[k], mine[k]))]
    assert not bad, f"{what}: {len(bad)}/{len(mine)} diverge; first {bad[:3]}"


# --- (a) against the compiled reference ------------------------------------


@needs_oracle
@pytest.mark.parametrize("seed", BOARD_SEEDS)
def test_board_parity(seed):
    assert np.array_equal(orc.oracle_board(seed), init_board_items_raw(seed))


def _trajectories(seeds, steps: int, kick: bool):
    """All seeds' trajectories in one batch, each board's dumps held
    against its oracle trajectory while the oracle ran it."""
    moves = np.stack([np.random.RandomState(seed ^ 0xABCDEF).randint(
        0, 6, size=(steps, 4)) for seed in seeds], 1).astype(np.int32)
    dumps = [orc.oracle_traj(seed, moves[:, k], kick=kick)
             for k, seed in enumerate(seeds)]
    s = init_states_np(seeds, device="cpu")
    if kick:
        s = s._replace(agent_can_kick=torch.ones_like(s.agent_can_kick))
    for t in range(max(len(d) for d in dumps)):
        if t:
            s = step(s, torch.from_numpy(moves[t - 1]))
        mine = orc.states_to_dumps(s)
        for k, seed in enumerate(seeds):
            if t < len(dumps[k]):
                d = orc.diff_dumps(dumps[k][t], mine[k])
                assert not d, (f"seed {seed} step {t} (kick={kick}): "
                               + "; ".join(d[:8]))


@needs_oracle
@pytest.mark.parametrize("kick", [False, True])
def test_trajectory_parity(kick):
    _trajectories(TRAJ_SEEDS, 120, kick)


@needs_oracle
@pytest.mark.parametrize("name", TWO)
def test_exhaustive_two_step_parity_oracle(name, sweeps):
    s = two_step._scenarios()[name]
    echo, dumps = orc.enum2_pair(orc.state_to_dump(state_of(_port(s), 0)),
                                 two_step.A, two_step.B)
    d = orc.diff_dumps(echo, orc.state_to_dump(state_of(_port(s), 0)))
    assert not d, "state injection diverged: " + "; ".join(d[:5])
    _held(dumps, sweeps["two"][name][1], name)


def _three_agent_oracle(name, s, n_moves):
    base = orc.state_to_dump(state_of(s, 0))
    echo, dumps = orc.enum3_trio(base, three_agent.A, three_agent.B,
                                 three_agent.C, n_moves=n_moves)
    d = orc.diff_dumps(echo, base)
    assert not d, "state injection diverged: " + "; ".join(d[:5])
    mv = state_fuzz.sweep_moves((three_agent.A, three_agent.B, three_agent.C),
                                n_moves)
    _held(dumps, state_fuzz.two_steps(s, mv), name)


@needs_oracle
@pytest.mark.parametrize("name", THREE)
def test_exhaustive_three_agent_parity_oracle(name):
    _three_agent_oracle(name, _port(three_agent._scenarios()[name]), 5)


@needs_oracle
def test_exhaustive_three_agent_with_bombs_oracle():
    _three_agent_oracle("train_kick+bombs",
                        _port(three_agent._scenarios()["train_kick"]), 6)


ALL_MOVES = np.stack([np.asarray([(c // 6 ** i) % 6 for i in range(4)])
                      for c in range(1296)]).astype(np.int32)


@needs_oracle
@pytest.mark.parametrize(
    "seed,warm,kick",
    [(0x1337, 0, False), (2, 25, False), (3, 25, True), (5, 40, True)])
def test_exhaustive_one_step_parity_oracle(seed, warm, kick):
    warm_moves = np.random.RandomState(seed ^ 0x5A5A).randint(
        0, 6, size=(warm, 4))
    out = subprocess.run(
        [orc.ORACLE_BIN, "enumkick" if kick else "enum1", hex(seed),
         str(warm)],
        input="\n".join(" ".join(str(int(m)) for m in row)
                        for row in warm_moves),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    dumps = [json.loads(line) for line in out.stdout.splitlines()
             if line.strip()]
    assert len(dumps) == 1297
    s = init_state_np(seed, device="cpu")
    if kick:
        s = s._replace(agent_can_kick=torch.ones_like(s.agent_can_kick))
    for mv in warm_moves:
        s = step(s, torch.from_numpy(mv[None].astype(np.int32)))
    d = orc.diff_dumps(dumps[0], orc.state_to_dump(state_of(s, 0)))
    assert not d, "warmup state diverged: " + "; ".join(d[:5])
    _held(dumps[1:], step(state_fuzz.repeat(s, 1296),
                          torch.from_numpy(ALL_MOVES)), f"seed {seed}")


def run_simple_game_parity(seed: int, steps: int):
    """Full-game SimpleAgent parity vs the oracle's "simple" mode: moves
    and post-step state every step, the agents' mt19937_64 streams on the
    host advanced only when an act consumes its draw."""
    out = subprocess.run([orc.ORACLE_BIN, "simple", hex(seed), str(steps)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.strip()]
    state_dumps = [line for line in lines if "board" in line]
    move_dumps = [line["moves"] for line in lines if "moves" in line]
    s = init_state_np(seed, device="cpu")
    asts = [simple_agent_init((1,), "cpu") for _ in range(4)]
    rngs = [MT19937_64((seed * 7919 + i) & ((1 << 64) - 1)) for i in range(4)]
    dist = UniformIntDistribution(0, 4)
    d = orc.diff_dumps(state_dumps[0], orc.state_to_dump(state_of(s, 0)))
    assert not d, f"seed {seed} initial: " + "; ".join(d)
    for t, ref_moves in enumerate(move_dumps):
        moves = []
        for i in range(4):
            if bool(s.agent_dead[0, i]):
                moves.append(0)
                continue
            peek = copy.deepcopy(rngs[i])
            rand = torch.tensor([dist(peek)], dtype=torch.int32)
            mv, consumed, asts[i] = simple_agent_act(s, i, asts[i], rand)
            if bool(consumed[0]):
                rngs[i] = peek
            moves.append(int(mv[0]))
        assert moves == ref_moves, f"seed {seed} step {t}: {moves}"
        s = step(s, torch.tensor([moves], dtype=torch.int32))
        d = orc.diff_dumps(state_dumps[t + 1],
                           orc.state_to_dump(state_of(s, 0)))
        assert not d, f"seed {seed} step {t} state: " + "; ".join(d[:8])


@needs_oracle
@pytest.mark.parametrize("seed", SIMPLE_SEEDS)
def test_simple_agent_game_parity(seed):
    run_simple_game_parity(seed, steps=80)


@pytest.mark.soak
@needs_oracle
@pytest.mark.parametrize("kick", [False, True])
def test_trajectory_parity_soak(kick):
    _trajectories(SOAK_TRAJ_SEEDS, 800, kick)


@pytest.mark.soak
@needs_oracle
@pytest.mark.parametrize("seed", SOAK_SIMPLE_SEEDS)
def test_simple_agent_game_parity_soak(seed):
    run_simple_game_parity(seed, steps=800)


@pytest.mark.soak
@needs_oracle
@pytest.mark.parametrize("name", ["train_no_kick", "cross"])
def test_exhaustive_three_agent_full_alphabet(name):
    _three_agent_oracle(name + "+bombs", _port(three_agent._scenarios()[name]),
                        6)


@pytest.mark.soak
@needs_oracle
@pytest.mark.parametrize("seed,snap", SNAPSHOTS)
def test_randomized_state_exhaustive_sweep(seed, snap):
    bad = state_fuzz.fuzz_one(seed, snap, 5, "cpu")
    if bad is None:
        pytest.skip("snapshot has < 3 live agents")
    assert bad == 0


# --- (b) against JAX on the CPU --------------------------------------------


def _jax_snapshot(seed, snap_step):
    """``scripts/state_fuzz.py``'s snapshot on JAX's engine."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    s = jax_init_state_np(seed)
    if seed % 2 == 1:
        s = s._replace(agent_can_kick=jnp.ones((4,), bool))
    for _ in range(snap_step):
        s = JAX_STEP(s, jnp.asarray(rng.randint(0, 6, 4), jnp.int32))
        if int(s.alive_count) < 3:
            return None
    return s


def _jax_two_steps(states, moves):
    """JAX's two exact steps of every sequence of every (state, moves)
    pair (``moves`` [2, n, 4]), as numpy trees [n, ...] a pair.  The
    reference's work is cut without changing a result: step 1 runs once per
    distinct first move, one board at a time; step 2 runs as ONE
    ``vmap(step)`` call over the distinct (state after step 1, second move)
    pairs of all the sequences, and each sequence takes its pair's
    result."""
    rows, index, sid = [], {}, []
    for st, mv in zip(states, moves):
        firsts, inv = np.unique(mv[0], axis=0, return_inverse=True)
        ids = []
        for u in firsts:
            one = jax.tree.map(np.asarray, JAX_STEP(st, jnp.asarray(u)))
            key = b"".join(x.tobytes() for x in jax.tree.leaves(one))
            ids.append(index.setdefault(key, len(rows)))
            if ids[-1] == len(rows):
                rows.append(one)
        sid.append(np.asarray(ids)[inv.reshape(-1)])
    second = np.concatenate([m[1] for m in moves]).astype(np.int64)
    code = np.concatenate(sid) * 6 ** 4 + second @ (6 ** np.arange(4))
    pairs, inv = np.unique(code, return_inverse=True)
    batch = jax.tree.map(lambda *xs: np.stack(xs)[pairs // 6 ** 4], *rows)
    mv2 = (pairs[:, None] % 6 ** 4 // 6 ** np.arange(4)) % 6
    out = jax.jit(jax.vmap(jax_step))(batch, jnp.asarray(mv2, jnp.int32))
    out = jax.tree.map(lambda x: np.asarray(x)[inv.reshape(-1)], out)
    edges = np.cumsum([0] + [m.shape[1] for m in moves])
    return [_slice(out, slice(a, b)) for a, b in zip(edges[:-1], edges[1:])]


def _port_two_steps(states, moves):
    """The port's two exact steps of every (state, moves) pair, all pairs
    in ONE batched call: port trees [n, ...] a pair."""
    sizes = [m.shape[1] for m in moves]
    start = jax.tree.map(lambda *xs: np.concatenate(
        [np.broadcast_to(np.asarray(x), (n,) + x.shape)
         for x, n in zip(xs, sizes)]), *states)
    out = state_fuzz.two_steps(state_to_torch(start, "cpu"),
                               np.concatenate(moves, 1))
    edges = np.cumsum([0] + sizes)
    return [map_state(lambda t: t[a:b], out)
            for a, b in zip(edges[:-1], edges[1:])]


def _slice(tree, sl):
    return jax.tree.map(lambda x: x[sl], tree)


@pytest.fixture(scope="module")
def snapshots():
    """The soak tier's snapshots on both engines and their n = 5 sweep
    moves: {(seed, snap): (JAX snapshot, port snapshot, moves)}."""
    out = {}
    for k in SNAPSHOTS:
        js = _jax_snapshot(*k)
        (_, _, ts), = state_fuzz.snapshots(*zip(k), device="cpu")
        assert js is not None
        out[k] = (js, ts,
                  state_fuzz.sweep_moves(state_fuzz.live_agents(ts)[:3], 5))
    return out


@pytest.fixture(scope="module")
def sweeps(snapshots):
    """Every sequence of the six two-step scenarios (36 x 36), the three
    three-agent scenarios (125 x 125) and the three snapshots (125 x 125):
    the port in ONE call a kind, JAX in one batch call for all
    (``_jax_two_steps``).  {"two" | "three" | "snap": {key: (JAX out, port
    out)}}."""
    two, three = two_step._scenarios(), three_agent._scenarios()
    mv2 = np.asarray(two_step._sweep_moves())
    mv3 = np.asarray(three_agent._sweep_moves(5))
    kinds = {"two": {n: (two[n], mv2) for n in TWO},
             "three": {n: (three[n], mv3) for n in THREE},
             "snap": {k: (js, mv) for k, (js, _, mv) in snapshots.items()}}
    pairs = [p for kind in kinds.values() for p in kind.values()]
    ref = iter(_jax_two_steps(*zip(*pairs)))
    out = {}
    for name, kind in kinds.items():
        mine = _port_two_steps(*zip(*kind.values()))
        out[name] = {k: (next(ref), m) for k, m in zip(kind, mine)}
    return out


@pytest.mark.parametrize("name", TWO)
def test_two_step_scenarios_match_jax(name, sweeps):
    """All 36 x 36 two-step joint moves of the scenario's two agents."""
    jout, tout = sweeps["two"][name]
    assert tout.board.shape[0] == 1296
    assert_same(jout, tout, name)


@pytest.mark.parametrize("name", THREE)
def test_three_agent_scenarios_match_jax(name, sweeps):
    """All 125 x 125 two-step moves of the scenario's three agents."""
    jout, tout = sweeps["three"][name]
    assert tout.board.shape[0] == 5 ** 6
    assert_same(jout, tout, name)


def test_sweep_moves_are_the_jax_suites_order():
    """``state_fuzz.sweep_moves`` is the oracle's ``loadenum3`` order as the
    JAX suite encodes it."""
    for n in (5, 6):
        got = state_fuzz.sweep_moves((0, 1, 2), n)
        assert np.array_equal(got, np.asarray(three_agent._sweep_moves(n)))


@pytest.mark.parametrize("seed,snap", SNAPSHOTS)
def test_fuzz_snapshot_is_the_jax_snapshot(seed, snap, snapshots):
    jsnap, tsnap, _ = snapshots[(seed, snap)]
    assert_same(jax.tree.map(lambda x: np.asarray(x)[None], jsnap), tsnap,
                f"snapshot {seed}@{snap}")
    assert int(tsnap.alive_count[0]) >= 3
    if seed % 2:
        assert bool(tsnap.agent_can_kick.all())


def test_find_snapshots_follows_the_jax_script(monkeypatch):
    """The command line's first states: the JAX script's seeds, snapshot
    steps and states (its loop over attempts, on JAX's engine), from the
    port's batched search."""
    monkeypatch.setattr(state_fuzz, "SEARCH_BATCH", 16)
    rng = np.random.RandomState(0)
    ref, attempt = [], 0
    while len(ref) < 3:
        snap = int(rng.randint(20, 90))
        js = _jax_snapshot(attempt, snap)
        if js is not None:
            ref.append((attempt, snap, js))
        attempt += 1
    got = list(state_fuzz.find_snapshots(3, 20, 90, 0, "cpu"))
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    for (_, _, js), (_, _, ts) in zip(ref, got):
        assert_same(jax.tree.map(lambda x: np.asarray(x)[None], js), ts)


@pytest.mark.parametrize("seed", [4, 5])
def test_snapshot_at_step_zero_is_the_initial_board(seed):
    """A snapshot step of 0 (``--steps-range 0,N``) is the seed's initial
    board, with kick on odd seeds, as the JAX script's zero-step loop
    leaves it; ``find_snapshots`` yields it."""
    (got_seed, snap, ts), = state_fuzz.snapshots([seed], [0], device="cpu")
    assert (got_seed, snap) == (seed, 0)
    js = _jax_snapshot(seed, 0)
    assert_same(jax.tree.map(lambda x: np.asarray(x)[None], js), ts,
                f"snapshot {seed}@0")
    first = next(state_fuzz.find_snapshots(1, 0, 1, 0, "cpu"))
    assert first[:2] == (0, 0)
    assert_same(jax.tree.map(lambda x: np.asarray(x)[None],
                             _jax_snapshot(0, 0)), first[2])


@pytest.mark.parametrize("seed,snap", SNAPSHOTS)
def test_fuzz_sweep_matches_jax(seed, snap, snapshots, sweeps):
    """``fuzz_one`` with JAX's sweep as its ``reference``: 0 mismatching
    dumps of 15,625; and the port's sweep field for field."""
    moves = snapshots[(seed, snap)][2]
    jout, tout = sweeps["snap"][(seed, snap)]
    assert_same(jout, tout, f"sweep {seed}@{snap}")

    def reference(s, mv):
        assert np.array_equal(mv, moves)
        return orc.states_to_dumps(state_to_torch(jout, "cpu"))

    stats = {}
    seen = []
    assert state_fuzz.fuzz_one(seed, snap, 5, "cpu", reference=reference,
                               verbose=seen.append, stats=stats) == 0
    assert stats["sequences"] == 5 ** 6 and "reference" in stats["held_by"]
    assert not seen

"""The exact engine's tooling in the port against the JAX package's, on the
CPU.

* ``testing.oracle``: ``state_to_dump`` / ``states_to_dumps`` /
  ``dump_to_text`` byte for byte against JAX's ``state_to_dump`` /
  ``dump_to_text`` on 64 reference boards advanced 0-60 random steps with
  kick (bombs in flight, flames, revealed powerups) and on the oracle
  suites' scenario states; ``diff_dumps`` line for line.
* ``core.state.board_get`` and the four strategy renderers
  (``render_rmap``, ``render_path``, ``render_dependency``,
  ``render_dependency_chain``) character for character against JAX's, each
  side drawing its own ``fill_rmap`` of every live agent and its own
  ``resolve_dependencies`` of every 6^4 joint move on two crafted states.
* ``play_demo`` and ``replay_viewer`` on JAX's move streams (the JAX
  scripts run unchanged: the demo's ``main``, the viewer's ``record``):
  every state, the printed game, the winner line, the npz arrays and the
  ``--frames`` text with colour pinned on and off; each package loads the
  other's replay.
* ``debug_divergence`` on injected SimpleAgent moves that diverge: its
  report against the same report built from JAX's ``from_state``,
  ``cellular_step`` and ``divergence_classes``.

Tolerance: exact equality of every string, dump and array.
"""

import argparse
import importlib.util
import io
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_exhaustive_2step as two_step
import test_exhaustive_3agent as three_agent
from pomcpp_tpu.core import state as jstate
from pomcpp_tpu.core.board_gen import init_state_np as jax_init_state_np
from pomcpp_tpu.engine import cellular as jcell
from pomcpp_tpu.engine import util as jutil
from pomcpp_tpu.engine.step import step as jax_step
from pomcpp_tpu.render import ascii as jascii
from pomcpp_tpu.strategy.rmap import fill_rmap as jax_fill_rmap
from pomcpp_tpu.testing import divergence as jdiv
from pomcpp_tpu.testing import oracle as jorc
from pomcpp_tpu.utils import replay as jreplay
from pomcpp_tpu_torch import debug_divergence, play_demo, replay_viewer
from pomcpp_tpu_torch.convert import state_to_torch
from pomcpp_tpu_torch.core.board_gen import init_states_np
from pomcpp_tpu_torch.core.constants import C_EXTRABOMB, C_FLAME, C_KICK
from pomcpp_tpu_torch.core.state import (
    board_get,
    empty_state,
    map_state,
    stack_states,
    state_of,
)
from pomcpp_tpu_torch.engine import util
from pomcpp_tpu_torch.engine.step import step
from pomcpp_tpu_torch.render import ascii as tascii
from pomcpp_tpu_torch.strategy.rmap import fill_rmap
from pomcpp_tpu_torch.testing import oracle as orc
from pomcpp_tpu_torch.utils import replay as treplay
from test_torch_divergence import GAMES, STEPS, _simple_moves

ROOT = Path(__file__).resolve().parent.parent
B, MAX_T = 64, 60
JAX_FILL_RMAP = jax.jit(jax.vmap(jax_fill_rmap, in_axes=(0, None)))
JAX_FROM_STATE = jax.jit(jax.vmap(jcell.from_state))


def _script(name):
    """A JAX script of ``scripts/`` as a module, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_jax(one):
    """A port one-board State as the JAX package's State of numpy arrays."""
    leaves = {n: type(v)(*(t.numpy() for t in v)) if n in ("bombs", "flames")
              else v.numpy() for n, v in zip(one._fields, one)}
    return jstate.State(**{**leaves,
                           "bombs": jstate.Bombs(*leaves["bombs"]),
                           "flames": jstate.Flames(*leaves["flames"])})


@pytest.fixture(scope="module")
def mid_game():
    """Board k of 64 reference boards with kick, after k * 60 // 63 random
    steps of the port's exact engine (which equals JAX's)."""
    s = init_states_np(range(B), device="cpu")
    s = s._replace(agent_can_kick=torch.ones_like(s.agent_can_kick))
    rng = np.random.RandomState(11)
    at = [k * MAX_T // (B - 1) for k in range(B)]
    snaps = [None] * B
    for t in range(MAX_T + 1):
        for k in range(B):
            if at[k] == t:
                snaps[k] = state_of(s, k)
        s = step(s, torch.from_numpy(rng.randint(0, 6, (B, 4))
                                     .astype(np.int32)))
    return stack_states(snaps)


# --- The oracle's dump format ----------------------------------------------


def test_state_to_dump_matches_jax_mid_game(mid_game):
    s = mid_game
    batch = orc.states_to_dumps(s)
    for k in range(B):
        one = state_of(s, k)
        ref = jorc.state_to_dump(_as_jax(one))
        got = orc.state_to_dump(one)
        assert got == ref and batch[k] == ref, k
        assert orc.dump_to_text(got) == jorc.dump_to_text(ref), k
        assert all(type(v) is int for v in got["board"] + [got["alive"]])
    # What the boards hold: bombs moving and parked, flames (some carrying
    # a powerup flag), revealed powerups, dead agents and wrapped queues.
    dirs = [b[5] for d in batch for b in d["bombs"]]
    board = s.board.numpy()
    flame = board == C_FLAME
    assert any(dirs) and not all(dirs)
    assert flame.any() and (s.hidden_pow.numpy()[flame] & 3).any()
    assert ((board >= C_EXTRABOMB) & (board <= C_KICK)).any()
    assert s.agent_dead.any() and (s.bomb_head > 0).any()


def test_state_to_dump_matches_jax_on_suite_scenarios():
    states = [*two_step._scenarios().values(),
              *three_agent._scenarios().values()]
    for js in states:
        one = state_of(state_to_torch(jax.tree.map(
            lambda x: np.asarray(x)[None], js), "cpu"), 0)
        ref = jorc.state_to_dump(js)
        assert orc.state_to_dump(one) == ref
        assert orc.dump_to_text(orc.state_to_dump(one)) == \
            jorc.dump_to_text(ref)


def test_diff_dumps_matches_jax(mid_game):
    a = orc.state_to_dump(state_of(mid_game, 40))
    b = orc.state_to_dump(state_of(mid_game, 41))
    c = {**a, "board": list(a["board"]), "alive": a["alive"] - 1}
    c["board"][7] += 5
    for x, y in ((a, b), (a, c), (c, a), (a, a)):
        assert orc.diff_dumps(x, y) == jorc.diff_dumps(x, y)
    assert orc.diff_dumps(a, c)[0].startswith("board[7] (x=7,y=0): ref=")


# --- board_get and the strategy renderers ----------------------------------


def test_board_get_matches_jax(mid_game):
    xs = torch.arange(B) % 11
    ys = (torch.arange(B) * 7) % 11
    got = board_get(mid_game, xs, ys)
    got_int = board_get(mid_game, 3, 9)
    for k in range(B):
        one = _as_jax(state_of(mid_game, k))
        assert int(got[k]) == int(jstate.board_get(one, int(xs[k]),
                                                   int(ys[k])))
        assert int(got_int[k]) == int(jstate.board_get(one, 3, 9))
    assert got.shape == (B,) and got_int.shape == (B,)


def _row(r, k):
    return type(r)(*(t[k] for t in r))


@pytest.mark.parametrize("color", [True, False])
def test_rmap_renderers_match_jax(mid_game, color):
    """``render_rmap`` and ``render_path`` of every live agent's map, each
    package drawing its own ``fill_rmap``; the paths to every reachable
    cell a few boards, and to an unreachable one."""
    js = jax.tree.map(jnp.asarray, _as_jax(mid_game))
    dead = mid_game.agent_dead.numpy()
    drawn = 0
    for a in range(4):
        mine = fill_rmap(mid_game, a)
        ref = jax.tree.map(np.asarray, JAX_FILL_RMAP(js, a))
        for k in np.nonzero(~dead[:, a])[0]:
            rm, jr = _row(mine, k), _row(ref, k)
            assert tascii.render_rmap(rm, color) == \
                jascii.render_rmap(jr, color)
            dist = jr.dist
            targets = np.nonzero(dist)[0]
            targets = targets if k % 16 == 0 else targets[::17]
            unreached = np.nonzero((dist == 0)
                                   & (np.arange(121) != jr.source))[0][:1]
            for c in [*targets, *unreached]:
                assert tascii.render_path(rm, int(c), color) == \
                    jascii.render_path(jr, int(c), color), (a, k, c)
                drawn += 1
    assert drawn > 500


def _dependency_states():
    """A 2x2 ring and a line of four (the JAX helpers' states), every agent
    alive."""
    ring, line = jstate.empty_state(), jstate.empty_state()
    for a, (x, y) in enumerate([(5, 5), (6, 5), (6, 6), (5, 6)]):
        ring = jstate.put_agent(ring, x, y, a)
        line = jstate.put_agent(line, 2 + a, 4, a)
    return [state_to_torch(jax.tree.map(lambda x: np.asarray(x)[None], st),
                           "cpu") for st in (ring, line)]


def test_dependency_renderers_match_jax():
    """Each package's ``resolve_dependencies`` of every 6^4 joint move
    (after ``fill_dest_pos`` and ``fix_switch_move``) drawn by its own
    renderers: equal strings, every board."""
    moves = np.array(list(itertools.product(range(6), repeat=4)), np.int32)
    n = moves.shape[0]

    def jax_deps(s, m):
        dx, dy = jutil.fill_dest_pos(s, m)
        dx, dy = jutil.fix_switch_move(s, dx, dy)
        return jutil.resolve_dependencies(s, dx, dy)

    jfn = jax.jit(jax.vmap(jax_deps))
    chains = 0
    for s1 in _dependency_states():
        s = map_state(lambda t: t.expand((n,) + t.shape[1:]).contiguous(), s1)
        dx, dy = util.fill_dest_pos(s, torch.from_numpy(moves))
        dx, dy = util.fix_switch_move(s, dx, dy)
        dep, roots, _ = util.resolve_dependencies(s, dx, dy)
        js = jax.tree.map(jnp.asarray, _as_jax(s))
        jdep, jroots, _ = jax.tree.map(np.asarray, jfn(js, moves))
        for k in range(n):
            assert tascii.render_dependency(dep[k]) == \
                jascii.render_dependency(jdep[k]), k
            got = tascii.render_dependency_chain(dep[k], roots[k])
            assert got == jascii.render_dependency_chain(jdep[k], jroots[k])
            chains += "<-" in got
    assert chains > 100


# --- The demo and the replay viewer ----------------------------------------


class _Tty(io.StringIO):
    def isatty(self):
        return True


def _jax_random_moves(seed, steps):
    """The JAX scripts' random-policy moves: per step, one split of the
    running key and a ``random_agent`` draw per agent (before the dead
    agents' moves are zeroed)."""
    def body(key, _):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, 4)
        return key, jax.vmap(
            lambda kk: jax.random.randint(kk, (), 0, 6, jnp.int32))(keys)
    _, mv = jax.lax.scan(body, jax.random.PRNGKey(seed), None, length=steps)
    return np.array(mv)


def test_play_demo_matches_the_jax_script(monkeypatch):
    """The JAX demo's ``main`` (random policy, no render) and the port's on
    the same moves: every state, the printed final board and the winner."""
    seed, steps = 0x2468, 500
    moves = _jax_random_moves(seed, steps)
    monkeypatch.setattr(sys, "argv", ["play_demo.py", "--policy", "random",
                                      "--no-render", "--seed", str(seed)])
    ref_out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", ref_out)
    _script("play_demo").main()

    s = jax_init_state_np(seed)
    s = s._replace(agent_can_kick=jnp.ones((4,), bool))
    jstep = jax.jit(jax_step)
    ref_states = []
    for t in range(steps):
        s = jstep(s, jnp.where(s.agent_dead, 0, moves[t]))
        s = s._replace(timestep=s.timestep + 1)
        ref_states.append(s)
        if int(s.alive_count) <= 1:
            break
    got_states = []
    play_demo.play_game(seed, steps, moves=moves, device="cpu",
                        on_step=lambda t, st, mv: got_states.append(st))
    assert len(got_states) == len(ref_states) < steps
    for t, (a, b) in enumerate(zip(ref_states, got_states)):
        assert orc.state_to_dump(state_of(b, 0)) == jorc.state_to_dump(a), t
        assert int(b.timestep[0]) == int(a.timestep) == t + 1

    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    play_demo.main(["--policy", "random", "--no-render", "--seed", str(seed),
                    "--device", "cpu"], moves=moves)
    monkeypatch.undo()
    assert out.getvalue() == ref_out.getvalue()
    assert out.getvalue().rstrip().splitlines()[-1].startswith("Finished!")


def test_demo_policies_replay_as_injected_moves():
    """Each policy's game on the CPU replayed from the moves it played:
    the same states; dead agents idle, ``timestep`` advanced every step,
    the harmless policy never plants."""
    for policy, steps in (("simple", 24), ("random", 60), ("harmless", 24)):
        seen, log = [], []
        final, n = play_demo.play_game(
            0x1337, steps, policy, device="cpu",
            on_step=lambda t, s, mv: (seen.append(s), log.append(mv[0])))
        assert n == len(log) and int(final.timestep[0]) == n
        again, m = play_demo.play_game(0x1337, steps, moves=torch.stack(log),
                                       device="cpu")
        assert m == n
        assert_state_equal(final, again)
        for before, mv in zip([None] + seen[:-1], log):
            if before is not None:
                assert not (mv[before.agent_dead[0]] != 0).any()
        if policy == "harmless":
            assert int(torch.stack(log).max()) < 5


def assert_state_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        pairs = zip(x, y) if name in ("bombs", "flames") else [(x, y)]
        for u, v in pairs:
            assert torch.equal(u, v), name


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """The JAX viewer's ``record`` (random policy, its defaults) and the
    port's on the moves it saved: both npz paths."""
    d = tmp_path_factory.mktemp("replays")
    jax_path, port_path = str(d / "jax.npz"), str(d / "port.npz")
    out = io.StringIO()
    saved = sys.stdout
    sys.stdout = out
    try:
        _script("replay_viewer").record(argparse.Namespace(
            record=jax_path, seed=0x1337, steps=120, policy="random"))
    finally:
        sys.stdout = saved
    moves = np.load(jax_path)["moves"]
    replay_viewer.record(port_path, 0x1337, 120, "random", "cpu",
                         moves=moves)
    return jax_path, port_path, out.getvalue()


def test_record_matches_the_jax_viewer(replays, capsys):
    jax_path, port_path, jax_line = replays
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        assert a["moves"].shape == (120, 4)
    # The port's command line prints the JAX script's line.
    moves = np.load(jax_path)["moves"]
    replay_viewer.main(["--record", port_path, "--policy", "random",
                        "--device", "cpu"], moves=moves)
    assert capsys.readouterr().out == jax_line.replace(jax_path, port_path)


@pytest.mark.parametrize("tty", [False, True])
def test_frames_match_the_jax_viewer(replays, monkeypatch, tty):
    """``--frames 10:14`` of either npz prints the same text in both
    viewers (``color = sys.stdout.isatty()``, pinned here), and each
    package loads the other's replay."""
    jax_path, port_path, _ = replays
    jrv = _script("replay_viewer")
    texts = []
    for path in (jax_path, port_path):
        for show in (lambda p: jrv.view(argparse.Namespace(
                         view=p, frames="10:14")),
                     lambda p: replay_viewer.view(p, "10:14")):
            out = _Tty() if tty else io.StringIO()
            monkeypatch.setattr(sys, "stdout", out)
            show(path)
            monkeypatch.undo()
            texts.append(out.getvalue())
    assert len(set(texts)) == 1
    assert texts[0].count("--- step ") == 4 and ("\033[" in texts[0]) == tty
    js, jm = jreplay.load_replay(port_path, jstate.empty_state())
    ts, tm = treplay.load_replay(jax_path, empty_state(None, "cpu"))
    assert np.array_equal(np.asarray(jm), tm.numpy())
    for t in (0, 60, 120):
        assert tascii.render_state(treplay.replay_frame(ts, t)) == \
            jascii.render_state(jreplay.replay_frame(js, t))


# --- The divergence debugger -----------------------------------------------


def _jax_report(moves):
    """``scripts/debug_divergence.py``'s loop and report on injected moves
    (batch index 0 of GAMES boards, seed 0), from JAX's functions."""
    cmp_fields = [f for f in jcell.CellState._fields if f != "timestep"]

    @jax.jit
    def census_step(s, c, mv):
        s2 = jax.vmap(jax_step)(s, mv)
        e2 = jax.vmap(jcell.from_state)(s2)
        c2 = jax.vmap(jcell.cellular_step)(c, mv)
        eq = jnp.ones(mv.shape[0], bool)
        for f in cmp_fields:
            a, b = getattr(e2, f), getattr(c2, f)
            d = (a != b).reshape(mv.shape[0], -1).any(axis=1) \
                if a.ndim > 1 else (a != b)
            eq = eq & ~d
        c_next = jax.tree.map(lambda ce, ee: jnp.where(
            eq.reshape((-1,) + (1,) * (ce.ndim - 1)), ce, ee), c2, e2)
        return s2, c_next, c2, eq, s.alive_count > 1

    s = jax.tree.map(lambda *xs: jnp.stack(xs),
                     *[jax_init_state_np(g) for g in range(GAMES)])
    kick = jnp.asarray([(g % 2) == 1 for g in range(GAMES)])
    s = s._replace(agent_can_kick=jnp.broadcast_to(kick[:, None], (GAMES, 4)))
    c = jax.vmap(jcell.from_state)(s)
    lines = []
    for t in range(STEPS):
        mv = moves[t]
        s_pre = s
        s, c, c2, eq, live = census_step(s, c, jnp.asarray(mv))
        neq = np.asarray(~eq & live)
        if neq.any():
            pre_cell, post_cell = JAX_FROM_STATE(s_pre), JAX_FROM_STATE(s)
            for i in np.nonzero(neq)[0]:
                one = lambda tree: jax.tree.map(lambda x: x[i], tree)  # noqa
                one_post, one_c2 = one(post_cell), one(c2)
                cl = jdiv.divergence_classes(one(pre_cell), mv[i], one_post,
                                             pre_exact=one(s_pre))
                lines.append(f"t={t} board={int(i)} mv={mv[i].tolist()} "
                             f"classes={cl}")
                for f in cmp_fields:
                    av = np.asarray(getattr(one_post, f))
                    bv = np.asarray(getattr(one_c2, f))
                    if not np.array_equal(av, bv):
                        w = np.nonzero(np.atleast_1d(av != bv))[0][:8]
                        lines.append(f"  {f}@{w.tolist()}: "
                                     f"exact={np.atleast_1d(av)[w]}"
                                     f" cell={np.atleast_1d(bv)[w]}")
        if not bool(np.asarray(live).any()):
            break
    return lines


def test_debug_divergence_matches_the_jax_report(capsys):
    moves = _simple_moves()
    ref = _jax_report(moves)
    got = debug_divergence.debug_report(0, GAMES, STEPS, 0, device="cpu",
                                        moves=moves, log=lambda m: None)
    assert got == ref
    assert sum(line.startswith("t=") for line in ref) >= 2
    assert any("classes=['" in line for line in ref)
    # The command line prints the same report; --boards keeps those boards
    # (run up to the first divergence's step).
    t0, first = (int(f.split("=")[1]) for f in ref[0].split()[:2])
    debug_divergence.main(["--batch-index", "0", "--batch", str(GAMES),
                           "--steps", str(t0 + 1), "--boards", str(first),
                           "--device", "cpu"], moves=moves)
    out = capsys.readouterr().out.splitlines()
    assert out and all(f"board={first} " in line for line in out
                       if line.startswith("t="))
    assert set(out) <= set(ref)

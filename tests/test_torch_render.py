"""The port's queue-encoded ``State``, its plane conversions, the renderer
and replays against the JAX package's, on the CPU.

Boards: 16 from ``random_cell_state`` stepped 12 random steps by the port's
``cellular_step`` (which equals JAX's), with agents killed on some of them,
so that bombs, flames and dead agents are all drawn.  Every comparison is
exact: ``to_state`` / ``from_state`` leaf for leaf, ``render_state``
byte for byte, replays array for array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.engine import cellular as jcell
from pomcpp_tpu.render import ascii as jascii
from pomcpp_tpu.utils import replay as jreplay
from pomcpp_tpu_torch.convert import state_to_torch, to_numpy, to_torch
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.core.queue import logical_view
from pomcpp_tpu_torch.core.state import empty_state
from pomcpp_tpu_torch.engine import cellular as tcell
from pomcpp_tpu_torch.engine.cellular import board_of
from pomcpp_tpu_torch.render import ascii as tascii
from pomcpp_tpu_torch.utils import replay as treplay

B = 16


@pytest.fixture(scope="module")
def boards():
    """Port boards mid-game, with some agents dead."""
    cs = random_cell_state(B, seed=7, device="cpu")
    rng = np.random.RandomState(3)
    for t in range(12):
        moves = rng.randint(0, 5, (B, 4))
        moves[rng.rand(B, 4) < 0.2] = 5               # bombs, one in five
        cs = tcell.cellular_step(cs, torch.from_numpy(moves).int())
        cs = cs._replace(timestep=cs.timestep + 1)
    dead = cs.agent_dead.clone()
    dead[0, 1] = dead[3, [0, 2]] = dead[5, :3] = True
    return cs._replace(agent_dead=dead,
                       alive_count=(4 - dead.sum(1)).int())


def _jax_board(cs, i):
    return type(jcell.empty_cell_state())(
        *(jnp.asarray(a[i]) for a in to_numpy(cs)))


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), treplay._leaves(b)
    assert len(la) == len(lb)
    for k, (x, y) in enumerate(zip(la, lb)):
        x = np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert np.array_equal(x, y), k


def test_the_boards_hold_bombs_flames_and_dead_agents(boards):
    assert int((boards.bomb_timer > 0).sum()) >= 2 * B
    assert int((boards.flame_timer > 0).any(1).sum()) >= B // 2
    assert int(boards.agent_dead.sum()) >= B


def test_empty_state_and_logical_view_match_jax():
    from pomcpp_tpu.core import queue as jq
    from pomcpp_tpu.core.state import empty_state as jempty

    _leaves_equal(jempty(), empty_state(device="cpu"))
    f = np.arange(20, dtype=np.int32) * 3
    for head in (0, 7, 19):
        assert np.array_equal(np.asarray(jq.logical_view(jnp.asarray(f), head)),
                              logical_view(torch.from_numpy(f), head).numpy())


def test_to_state_matches_jax(boards):
    for i in range(B):
        _leaves_equal(jcell.to_state(_jax_board(boards, i)),
                      tcell.to_state(board_of(boards, i)))


def _rotated(state_j, bomb_head, flame_head):
    """The same queues stored from another head, stale records in the free
    slots: ``from_state`` must read through the heads."""
    def roll(q, h, junk):
        return type(q)(*(jnp.asarray(np.roll(np.where(
            np.arange(len(f)) < 20, np.asarray(f), junk), h)) for f in q))

    return state_j._replace(
        bombs=roll(state_j.bombs, bomb_head, 3), bomb_head=jnp.int32(bomb_head),
        flames=roll(state_j.flames, flame_head, 1),
        flame_head=jnp.int32(flame_head))


def test_from_state_matches_jax(boards):
    for i in range(B):
        sj = jcell.to_state(_jax_board(boards, i))
        for heads in ((0, 0), (5, 17), (19, 3)):
            sj2 = _rotated(sj, *heads)
            st = state_to_torch(sj2, "cpu")
            _leaves_equal(jcell.from_state(sj2), tcell.from_state(st))
        # The round trip gives the board back.
        back = tcell.from_state(tcell.to_state(board_of(boards, i)))
        _leaves_equal(jax.tree.map(np.asarray, _jax_board(boards, i)), back)


def test_render_state_matches_jax_byte_for_byte(boards):
    drawn = set()
    for i in range(B):
        cj, ct = _jax_board(boards, i), board_of(boards, i)
        sj = jcell.to_state(cj)
        st = tcell.to_state(ct)
        for color in (False, True):
            want = jascii.render_state(sj, color=color)
            assert tascii.render_state(st, color=color).encode() == \
                want.encode()
            assert tascii.render_state(ct, color=color).encode() == \
                jascii.render_state(cj, color=color).encode()
        rot = _rotated(sj, 6, 11)
        assert tascii.render_state(state_to_torch(rot, "cpu")) == \
            jascii.render_state(rot)
        drawn |= {g for g in ("●", "♨", "DEAD") if g in want}
    assert drawn == {"●", "♨", "DEAD"}


def test_print_state(capsys, boards):
    tascii.print_state(board_of(boards, 2), color=False, clear=True)
    out = capsys.readouterr().out
    assert out.startswith("\033c╔") and out.rstrip().endswith("alive=" + str(
        int(boards.alive_count[2])))


def _record_port(n_steps=10, board=1):
    cs = random_cell_state(3, seed=2, device="cpu")
    rng = np.random.RandomState(1)

    def moves_fn(t, game):
        return torch.from_numpy(rng.randint(0, 6, (3, 4))).int()

    def step_fn(game, mv):
        game = tcell.cellular_step(game, mv)
        return game._replace(timestep=game.timestep + 1)

    return treplay.record_game(cs, step_fn, moves_fn, n_steps, board=board)


def test_replay_written_by_the_port_loads_in_jax(tmp_path):
    states, moves = _record_port()
    assert states.board.shape == (11, 121) and moves.shape == (10, 4)
    path = str(tmp_path / "port_game")
    treplay.save_replay(path, states, moves)
    loaded, moves_j = jreplay.load_replay(path, jcell.empty_cell_state())
    assert np.array_equal(np.asarray(moves_j), moves.numpy())
    _leaves_equal(loaded, states)
    frame = treplay.replay_frame(states, 6)
    assert tascii.render_state(frame) == jascii.render_state(
        jreplay.replay_frame(loaded, 6))


def test_replay_written_by_jax_loads_in_the_port(tmp_path):
    """JAX's ``record_game`` stepping the port's engine, saved by JAX; a
    queue-encoded ``State`` replay too."""
    cs = random_cell_state(1, seed=4, device="cpu")
    rng = np.random.RandomState(2)

    def step_fn(game, mv):
        out = tcell.cellular_step(to_torch(jax.tree.map(
            lambda a: np.asarray(a)[None], game), "cpu"),
            torch.from_numpy(np.array(mv)[None]).int())
        return _jax_board(out._replace(timestep=out.timestep + 1), 0)

    states_j, moves_j = jreplay.record_game(
        _jax_board(cs, 0), step_fn,
        lambda t, g: jnp.asarray(rng.randint(0, 6, 4), jnp.int32), 8)
    path = str(tmp_path / "jax_game.npz")
    jreplay.save_replay(path, states_j, moves_j)
    loaded, moves = treplay.load_replay(path, board_of(cs, 0))
    assert np.array_equal(moves.numpy(), np.asarray(moves_j))
    _leaves_equal(states_j, loaded)

    frames = [jcell.to_state(jreplay.replay_frame(states_j, t))
              for t in (0, 8)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *frames)
    jreplay.save_replay(path, stacked, moves_j[:1])
    loaded, _ = treplay.load_replay(path, empty_state(device="cpu"))
    _leaves_equal(stacked, loaded)
    assert tascii.render_state(treplay.replay_frame(loaded, 1)) == \
        jascii.render_state(frames[1])
    with pytest.raises(ValueError, match="leaves"):
        treplay.load_replay(path, board_of(cs, 0))

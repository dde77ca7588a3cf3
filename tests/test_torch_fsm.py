"""The port's simple chunk vs ``pallas_rollout_chunk(interpret=True,
policy="simple")``, and the FSM state's kernel layout.

The TPU kernel's PRNG does not run off the TPU, so both sides take the
FSM's rands through ``moves=`` and fresh terrain through ``reset_boards=``.
Tolerance: exact equality of every CellState field, the recorded moves and
done marks, and the ten FSM state arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.core.board_gen import random_cell_state
from pomcpp_tpu.core.constants import C_AGENT0, C_BOMB
from pomcpp_tpu.engine.pallas_step import (
    pallas_rollout_chunk,
    simple_fsm_state_init as jax_fsm_init,
)
from pomcpp_tpu_torch.agents.simple import SimpleAgentState, simple_agent_init
from pomcpp_tpu_torch.convert import (
    diff_fields,
    fsm_to_simple_state,
    fsm_to_torch,
    simple_state_to_fsm,
    to_torch,
)
from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
from pomcpp_tpu_torch.engine.fused_step import rollout_chunk, rollout_chunk_plain

B, STEPS = 4, 12


def _boards(seed, b=B):
    return jax.tree.map(np.asarray, jax.vmap(random_cell_state)(
        jax.random.split(jax.random.PRNGKey(seed), b)))


def _mixed_batch(seed):
    """Board 0 generated; board 1 with all agents in a 4x4 corner window;
    board 2 with agents 0 and 1 dead in place (stale sources on passage);
    board 3 with agents 2 and 3 dead and agents 0 and 1 standing on bombs
    that explode this step, so the board finishes at step 0."""
    cs = _boards(seed)
    board, bt, bs = cs.board.copy(), cs.bomb_timer.copy(), cs.bomb_strength.copy()
    ax, ay, dead = cs.agent_x.copy(), cs.agent_y.copy(), cs.agent_dead.copy()
    for i in range(4):
        board[1:, ax[1:, i] + 11 * ay[1:, i]] = 0
    for i, (x, y) in enumerate(((1, 1), (3, 2), (2, 3), (3, 3))):
        ax[1, i], ay[1, i] = x, y
        board[1, x + 11 * y] = C_AGENT0 + i
    for i in (2, 3):
        board[2, ax[2, i] + 11 * ay[2, i]] = C_AGENT0 + i
    dead[2, :2] = True
    for i, (x, y) in enumerate(((5, 5), (6, 5))):
        ax[3, i], ay[3, i] = x, y
        c = x + 11 * y
        board[3, c] = C_AGENT0 + i
        bt[3, c], bs[3, c] = 1, 3
    board[3, 4 * 11:7 * 11] = np.where(board[3, 4 * 11:7 * 11] >= C_AGENT0,
                                       board[3, 4 * 11:7 * 11], 0)
    dead[3, 2:] = True
    return cs._replace(
        board=board, bomb_timer=bt, bomb_strength=bs, agent_x=ax, agent_y=ay,
        agent_dead=dead, alive_count=(4 - dead.sum(1)).astype(np.int32),
        timestep=np.arange(B, dtype=np.int32),
    )


def _run_both(cs, moves, fsm, **kw):
    reset = kw.pop("reset_boards", None)
    ref = pallas_rollout_chunk(
        jax.tree.map(jnp.asarray, cs), 0, steps=STEPS, interpret=True,
        policy="simple", moves=jnp.asarray(moves), record=True,
        fsm_state=tuple(map(jnp.asarray, fsm)),
        reset_boards=None if reset is None else tuple(map(jnp.asarray, reset)),
        **kw)
    got = rollout_chunk(
        to_torch(cs, "cpu"), 0, STEPS, "simple", moves=torch.from_numpy(moves),
        record=True, fsm_state=fsm_to_torch(fsm, "cpu"), device="cpu",
        reset_boards=None if reset is None else tuple(map(torch.tensor, reset)),
        **kw)
    bad = diff_fields(ref[0], got[0], skip=())
    assert not bad, f"fields differ: {bad}"
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy()), "moves"
    assert np.array_equal(np.asarray(ref[2]), got[2].numpy()), "done"
    for k, (a, b) in enumerate(zip(ref[3], got[3])):
        assert np.array_equal(np.asarray(a), b.numpy()), f"FSM array {k}"
    return got


def _rands(seed, hi=5):
    return np.random.RandomState(seed).randint(0, hi, size=(STEPS, B, 4)).astype(np.int32)


def _midway_fsm(seed):
    """A non-fresh FSM state: full rings, partial rings, stale slots."""
    rng = np.random.RandomState(seed)
    fsm = [np.asarray(a).copy() for a in jax_fsm_init(B)]
    count = rng.randint(0, 5, size=(B, 4))
    for j in range(4):
        code = (rng.randint(0, 11, size=(B, 4)) + 1) + 13 * (rng.randint(0, 11, size=(B, 4)) + 1)
        fsm[j] = np.where(j < count, code, fsm[j]).astype(np.int32)
        fsm[6 + j] = rng.randint(0, 5, size=(B, 4)).astype(np.int32)
    fsm[5] = count.astype(np.int32)
    return fsm


def test_chunk_injected_rands_without_reset():
    """(a) ``moves=`` rands, auto_reset off, a mid-game FSM state in."""
    cs = _mixed_batch(4)
    got = _run_both(cs, _rands(1), _midway_fsm(2), auto_reset=False)
    assert got[0].agent_dead[3].all()          # board 3 blew up
    assert (got[1][:, 2, :2] == 0).all()      # dead agents' moves zeroed


def test_chunk_with_reset_boards_and_auto_reset():
    """(b) auto-reset with ``reset_boards=``: board 0 finished at entry,
    board 3 finishes at step 0; both reset, FSM state included."""
    cs = _mixed_batch(5)
    dead = cs.agent_dead.copy()
    dead[0, 1:] = True
    cs = cs._replace(agent_dead=dead, alive_count=(4 - dead.sum(1)).astype(np.int32))
    fresh = _boards(123)
    got = _run_both(cs, _rands(3), _midway_fsm(4),
                    reset_boards=(fresh.board, fresh.hidden_pow))
    done = got[2].numpy()
    assert done[0, 3] and not done[0, 0]
    assert (got[0].alive_count >= 2).all()


def test_chunk_mixed_control_inject_slots():
    """(c) ``inject_slots=(0,)``: lane 0 plays the moves input (0-5, bombs
    included), the FSM drives lanes 1-3 with their rands from the same
    input and updates lane 0's state with lane 0's move as its rand."""
    cs = _mixed_batch(6)
    moves = _rands(5)
    moves[:, :, 0] = _rands(7, hi=6)[:, :, 0]
    got = _run_both(cs, moves, [np.asarray(a) for a in jax_fsm_init(B)],
                    auto_reset=False, inject_slots=(0,))
    live0 = ~cs.agent_dead[:, 0]
    assert np.array_equal(got[1][0, live0, 0].numpy(), moves[0, live0, 0])


def test_fsm_state_layout_round_trips():
    rng = np.random.RandomState(8)
    shape = (6, 4)
    ast = SimpleAgentState(
        rp_x=torch.from_numpy(rng.randint(-1, 12, size=shape + (4,)).astype(np.int32)),
        rp_y=torch.from_numpy(rng.randint(-1, 12, size=shape + (4,)).astype(np.int32)),
        rp_head=torch.from_numpy(rng.randint(0, 4, size=shape).astype(np.int32)),
        rp_count=torch.from_numpy(rng.randint(0, 5, size=shape).astype(np.int32)),
        mq_slots=torch.from_numpy(rng.randint(0, 5, size=shape + (4,)).astype(np.int32)),
    )
    fsm = simple_state_to_fsm(ast)
    assert len(fsm) == 10 and all(t.shape == shape and t.dtype == torch.int32 for t in fsm)
    assert (fsm.rp_head == 0).all()
    back = fsm_to_simple_state(fsm)
    again = simple_state_to_fsm(back)
    assert all(torch.equal(a, b) for a, b in zip(fsm, again))
    # Logical slot j is physical slot (head + j) % 4.
    for j in range(4):
        phys = ((ast.rp_head + j) % 4).long()[..., None]
        assert torch.equal(back.rp_x[..., j], ast.rp_x.gather(-1, phys)[..., 0])
        assert torch.equal(back.rp_y[..., j], ast.rp_y.gather(-1, phys)[..., 0])
    # A head-0 state comes back unchanged.
    ast0 = ast._replace(rp_head=torch.zeros_like(ast.rp_head))
    back0 = fsm_to_simple_state(simple_state_to_fsm(ast0))
    assert all(torch.equal(a, b) for a, b in zip(ast0, back0))
    # Fresh states agree across the two layouts and with the JAX package.
    init = simple_fsm_state_init(6, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(init, simple_state_to_fsm(simple_agent_init(shape, "cpu"))))
    assert all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jax_fsm_init(6), init))


def test_chunk_rejects_bad_simple_arguments():
    cs = to_torch(_boards(0), "cpu")
    fsm = simple_fsm_state_init(B, "cpu")
    with pytest.raises(ValueError, match="fsm_state"):
        rollout_chunk_plain(cs, 0, 1, "simple")
    with pytest.raises(ValueError, match="fsm_state"):
        rollout_chunk_plain(cs, 0, 1, "random", fsm_state=fsm)
    with pytest.raises(ValueError, match="inject_slots"):
        rollout_chunk_plain(cs, 0, 1, "simple", fsm_state=fsm, inject_slots=(0,))

"""The port's SimpleAgent toolkit and joint act vs the JAX package's.

Inputs are made with numpy from a seed (boards through
``jax.vmap(random_cell_state)``) and fed to both sides.  Tolerance: exact
equality, as all state is integer.  The act cases mirror
``tests/test_pallas_fsm.py``: generated boards, dead agents with stale
sources, the serpentine board and the close-quarters fuzz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pomcpp_tpu.agents.simple import simple_agent_init
from pomcpp_tpu.agents.simple_cellular import simple_agent_cell_act
from pomcpp_tpu.core.board_gen import random_cell_state
from pomcpp_tpu.core.constants import C_AGENT0, C_BOMB, C_RIGID
from pomcpp_tpu.core.state import empty_state, put_agent, put_item
from pomcpp_tpu.engine.cellular import cellular_step, from_state
from pomcpp_tpu.engine.util import desired_position as jax_desired_position
from pomcpp_tpu.strategy import cellular_toolkit as jtk
from pomcpp_tpu.strategy.moves import sort_directions as jax_sort_directions
from pomcpp_tpu_torch.agents.simple import (
    SimpleAgentState,
    simple_agent_init as port_agent_init,
)
from pomcpp_tpu_torch.agents.simple_cellular import simple_agent_cell_joint
from pomcpp_tpu_torch.convert import diff_fields, to_torch
from pomcpp_tpu_torch.engine.cellular import cellular_step as port_step
from pomcpp_tpu_torch.engine.util import desired_position
from pomcpp_tpu_torch.strategy import cellular_toolkit as ptk
from pomcpp_tpu_torch.strategy.moves import sort_directions

B = 4   # boards per case: one shape, so each JAX function compiles once


def _np(cs):
    return jax.tree.map(np.asarray, cs)


def _boards(seed, b=B):
    return _np(jax.vmap(random_cell_state)(jax.random.split(jax.random.PRNGKey(seed), b)))


def _bomb_boards(seed):
    """Generated boards with bombs of mixed strength and timer on free cells."""
    cs = _boards(seed)
    rng = np.random.RandomState(seed)
    board, bt, bs = cs.board.copy(), cs.bomb_timer.copy(), cs.bomb_strength.copy()
    for g in range(B):
        free = np.flatnonzero(board[g] == 0)
        for c in rng.choice(free, size=8, replace=False):
            board[g, c] = C_BOMB
            bt[g, c] = rng.randint(1, 11)
            bs[g, c] = rng.randint(1, 11)
    return cs._replace(board=board, bomb_timer=bt, bomb_strength=bs)


def _serpentine():
    """Walls down columns 1/3/5 with alternating openings: agent 0 is 6
    manhattan but 46 walkable steps from agent 1."""
    s = empty_state()
    for y in range(10):
        s = put_item(s, 1, y, C_RIGID)
        s = put_item(s, 5, y, C_RIGID)
    for y in range(1, 11):
        s = put_item(s, 3, y, C_RIGID)
    for i, (x, y) in enumerate(((0, 0), (6, 0), (8, 10), (10, 10))):
        s = put_agent(s, x, y, i)
    cs = from_state(s)
    return _np(jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), cs))


def _dead_stale(seed=9):
    """Agents 0 and 1 died in place; their cells reverted to passage."""
    cs = _boards(seed)
    board = cs.board.copy()
    for i in (0, 1):
        board[np.arange(B), cs.agent_x[:, i] + 11 * cs.agent_y[:, i]] = 0
    dead = np.zeros((B, 4), bool)
    dead[:, :2] = True
    return cs._replace(board=board, agent_dead=dead,
                       alive_count=np.full((B,), 2, np.int32))


def _close_quarters(seed):
    """All four agents dropped into a random 5x5 window of each board."""
    cs = _boards(seed)
    rng = np.random.RandomState(seed)
    board = cs.board.copy()
    rows = np.arange(B)
    for i in range(4):
        board[rows, cs.agent_x[:, i] + 11 * cs.agent_y[:, i]] = 0
    nx = np.zeros((B, 4), np.int32)
    ny = np.zeros((B, 4), np.int32)
    for g in range(B):
        ox, oy = rng.randint(0, 7, size=2)
        cells = rng.choice(25, size=4, replace=False)
        nx[g], ny[g] = ox + cells % 5, oy + cells // 5
    for i in range(4):
        board[rows, nx[:, i] + 11 * ny[:, i]] = C_AGENT0 + i
    return cs._replace(board=board, agent_x=nx, agent_y=ny)


TOOLKIT_CASES = {"bombs_s1": lambda: _bomb_boards(1),
                 "bombs_s2": lambda: _bomb_boards(2),
                 "serpentine": _serpentine}


@pytest.mark.parametrize("case", sorted(TOOLKIT_CASES))
def test_toolkit_matches_jax(case):
    cs = TOOLKIT_CASES[case]()
    jcs = jax.tree.map(jnp.asarray, cs)
    pcs = to_torch(cs, "cpu")
    ids = jnp.arange(4)

    jd = jax.vmap(jtk.danger_map_cell)(jcs)
    pd = ptk.danger_map_cell(pcs)
    assert np.array_equal(np.asarray(jd), pd.numpy())
    assert pd.numpy().max() > 0 or case == "serpentine"

    jr = jax.vmap(lambda c: jax.vmap(lambda a: jtk.fill_reach_map(c, a))(ids))(jcs)
    pr = ptk.fill_reach_map(pcs)
    for name in ("dist", "root", "source"):
        assert np.array_equal(np.asarray(getattr(jr, name)),
                              getattr(pr, name).numpy()), name
    if case == "serpentine":
        assert int(pr.dist[0, 0, 6]) == 46

    def safe_dirs(c, d):
        return jax.vmap(lambda a: jtk.safe_directions_cell(
            c, d, c.agent_x[a], c.agent_y[a]))(ids)

    jm, jc = jax.vmap(safe_dirs)(jcs, jd)
    pm, pc = ptk.safe_directions_cell(pcs, pd, pcs.agent_x, pcs.agent_y)
    assert np.array_equal(np.asarray(jm), pm.numpy())
    assert np.array_equal(np.asarray(jc), pc.numpy())

    jsafe = jax.vmap(lambda c, d, r: jax.vmap(
        lambda a, rr: jtk.move_towards_safe_place_cell(
            d, rr, jnp.maximum(d[c.agent_x[a] + 11 * c.agent_y[a]], 3)))(ids, r))
    # A radius of at least 3 makes the flee window non-trivial everywhere.
    rad = torch.maximum(ptk.read_at(pd, pcs.agent_x + 11 * pcs.agent_y),
                        torch.tensor(3))
    assert np.array_equal(np.asarray(jsafe(jcs, jd, jr)),
                          ptk.move_towards_safe_place_cell(pd, pr, rad).numpy())
    jen = jax.vmap(lambda c, r: jax.vmap(
        lambda rr: jtk.move_towards_enemy_cell(c, rr, 7))(r))(jcs, jr)
    assert np.array_equal(np.asarray(jen),
                          ptk.move_towards_enemy_cell(pcs, pr, 7).numpy())
    for dist in (1, 7):
        je = jax.vmap(lambda c: jax.vmap(
            lambda a: jtk.is_adjacent_enemy_cell(c, a, dist))(ids))(jcs)
        jw = jax.vmap(lambda c: jax.vmap(
            lambda a: jtk.is_adjacent_wood_cell(c, a, dist))(ids))(jcs)
        assert np.array_equal(np.asarray(je),
                              ptk.is_adjacent_enemy_cell(pcs, dist).numpy())
        assert np.array_equal(np.asarray(jw),
                              ptk.is_adjacent_wood_cell(pcs, dist).numpy())


def test_sort_directions_and_desired_position_match_jax():
    """Random queues against random rings, heads and counts (n = 512)."""
    rng = np.random.RandomState(5)
    n = 512
    slots = rng.randint(0, 6, size=(n, 4)).astype(np.int32)
    count = rng.randint(0, 5, size=n).astype(np.int32)
    x, y = (rng.randint(0, 11, size=n).astype(np.int32) for _ in range(2))
    # Ring entries near (x, y) so that many slots read as visited.
    rp_x = np.clip(x[:, None] + rng.randint(-1, 2, size=(n, 4)), -1, 11).astype(np.int32)
    rp_y = np.clip(y[:, None] + rng.randint(-1, 2, size=(n, 4)), -1, 11).astype(np.int32)
    head = rng.randint(0, 4, size=n).astype(np.int32)
    rpc = rng.randint(0, 5, size=n).astype(np.int32)
    args = (slots, count, rp_x, rp_y, head, rpc, x, y)
    js, jc = jax.jit(jax.vmap(jax_sort_directions))(*map(jnp.asarray, args))
    ps, pc = sort_directions(*map(torch.from_numpy, args))
    assert np.array_equal(np.asarray(js), ps.numpy())
    assert np.array_equal(np.asarray(jc), pc.numpy())
    assert (ps.numpy() != slots).any()   # the walk did rearrange queues

    mv = rng.randint(0, 6, size=n).astype(np.int32)
    jx, jy = jax_desired_position(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mv))
    px, py = desired_position(*map(torch.from_numpy, (x, y, mv)))
    assert np.array_equal(np.asarray(jx), px.numpy())
    assert np.array_equal(np.asarray(jy), py.numpy())


def _joint_with_rands(cs, asts, rands):
    """simple_agent_cell_joint of the JAX package with injected rands."""
    dmap = jtk.danger_map_cell(cs)
    ids = jnp.arange(4, dtype=jnp.int32)
    return jax.vmap(
        lambda aid, ast, rand: simple_agent_cell_act(cs, aid, ast, rand, dmap)
    )(ids, asts, rands)


_JOINT = jax.jit(jax.vmap(_joint_with_rands))
_STEP = jax.jit(jax.vmap(cellular_step))

ACT_CASES = {
    "generated_s0": (lambda: _boards(0), 12),
    "generated_s3": (lambda: _boards(3), 12),
    "dead_stale_sources": (_dead_stale, 10),
    "serpentine": (_serpentine, 3),
    "close_quarters_s21": (lambda: _close_quarters(21), 16),
    "close_quarters_s22": (lambda: _close_quarters(22), 16),
}


@pytest.mark.parametrize("case", sorted(ACT_CASES))
def test_joint_act_matches_jax(case):
    """Step by step: the moves played (dead agents' zeroed), the live
    agents' consumed flags and FSM state, and the stepped game state.
    Dead agents' FSM state follows the chunk kernel instead (their BFS
    sources are pruned); test_torch_fsm.py holds it to that kernel."""
    make, steps = ACT_CASES[case]
    cs = make()
    rng = np.random.RandomState(100 + steps)
    rands = rng.randint(0, 5, size=(steps, B, 4)).astype(np.int32)
    jcs = jax.tree.map(jnp.asarray, cs)
    jast = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, 4) + x.shape),
                        simple_agent_init())
    pcs = to_torch(cs, "cpu")
    past = port_agent_init((B, 4), "cpu")
    moved = 0
    for t in range(steps):
        live = ~np.asarray(jcs.agent_dead)
        jm, jcons, jast = _JOINT(jcs, jast, jnp.asarray(rands[t]))
        pm, pcons, past = simple_agent_cell_joint(pcs, past, torch.from_numpy(rands[t]))
        mv = np.where(live, np.asarray(jm), 0).astype(np.int32)
        assert np.array_equal(mv, torch.where(pcs.agent_dead, 0, pm).numpy()), \
            f"moves, step {t}"
        assert np.array_equal(np.asarray(jcons)[live], pcons.numpy()[live]), \
            f"consumed, step {t}"
        for name in SimpleAgentState._fields:
            assert np.array_equal(np.asarray(getattr(jast, name))[live],
                                  getattr(past, name).numpy()[live]), f"{name}, step {t}"
        moved += int((mv != 0).sum())
        jcs = _STEP(jcs, jnp.asarray(mv))
        pcs = port_step(pcs, torch.from_numpy(mv))
        assert not diff_fields(_np(jcs), pcs, skip=()), f"state, step {t}"
    assert moved > 0

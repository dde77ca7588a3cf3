"""The port's board generators vs the JAX generator, in distribution.

Bit equality is not expected (different generators).  Each rate is held to
its expected value within 5 standard errors of the sample, and the port's
and the JAX package's rates to each other within 5 standard errors of the
difference.
"""

import jax
import numpy as np

from pomcpp_tpu.core.board_gen import random_cell_state as jax_random_cell_state
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.core.constants import C_AGENT0, C_RIGID, C_WOOD, NUM_CELLS
from pomcpp_tpu_torch.engine.fused_step import fresh_terrain

N = 3000
CORNERS = (0, 10, 120, 110)
INNER = np.array([c for c in range(NUM_CELLS) if c not in CORNERS])


def _rates(board, hidden):
    board, hidden = board[:, INNER], hidden[:, INNER]
    wood = board == C_WOOD
    flagged = (hidden > 0) & wood
    flags = hidden[flagged]
    return {
        "rigid": ((board == C_RIGID).sum(), board.size, 1 / 7),
        "wood": (wood.sum(), board.size, 1 / 7),
        "flagged": (flagged.sum(), wood.sum(), 1 / 2),
        **{f"flag{v}": ((flags == v).sum(), flags.size, 1 / 4) for v in (1, 2, 3, 4)},
    }


def _check_rate(name, k, n, p):
    se = np.sqrt(p * (1 - p) / n)
    assert abs(k / n - p) < 5 * se, f"{name}: {k / n:.4f} vs {p:.4f}"


def _jax_boards():
    cs = jax.vmap(jax_random_cell_state)(jax.random.split(jax.random.PRNGKey(0), N))
    return np.asarray(cs.board), np.asarray(cs.hidden_pow)


def test_random_cell_state_layout():
    cs = random_cell_state(8, seed=3, device="cpu")
    assert cs.board.shape == (8, NUM_CELLS) and cs.agent_x.shape == (8, 4)
    for i, c in enumerate(CORNERS):
        assert (cs.board[:, c] == C_AGENT0 + i).all()
    assert cs.agent_x[0].tolist() == [0, 10, 10, 0]
    assert cs.agent_y[0].tolist() == [0, 0, 10, 10]
    assert (cs.agent_max_bombs == 1).all() and (cs.agent_strength == 1).all()
    assert not cs.agent_dead.any() and not cs.agent_can_kick.any()
    assert (cs.alive_count == 4).all() and (cs.timestep == 0).all()
    assert (cs.flame_timer == 0).all() and (cs.bomb_timer == 0).all()
    again = random_cell_state(8, seed=3, device="cpu")
    assert all((a == b).all() for a, b in zip(cs, again))


def test_distribution_matches_jax_generator():
    cs = random_cell_state(N, seed=1, device="cpu")
    port = _rates(cs.board.numpy(), cs.hidden_pow.numpy())
    ref = _rates(*_jax_boards())
    for name, (k, n, p) in port.items():
        _check_rate(name, k, n, p)
        k2, n2, _ = ref[name]
        _check_rate("jax " + name, k2, n2, p)
        se = np.sqrt(p * (1 - p) * (1 / n + 1 / n2))
        assert abs(k / n - k2 / n2) < 5 * se, name


def test_chunk_reset_terrain_distribution():
    """The chunk kernel's Philox terrain has the same distribution."""
    board, hidden = fresh_terrain(5, N, "cpu")
    for name, (k, n, p) in _rates(board.numpy(), hidden.numpy()).items():
        _check_rate(name, k, n, p)

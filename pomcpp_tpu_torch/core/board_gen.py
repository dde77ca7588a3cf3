"""Board generation: the reference's exact generator on the host, and
batched random boards on the device.

Counterpart of ``pomcpp_tpu.core.board_gen``:

* ``init_board_items_raw`` / ``init_board_items_np`` / ``init_state_np`` --
  bit-exact replica of the reference ``InitBoardItems`` / ``InitState``
  (bboard.cpp:338-381) with its quirks, driven by the host-side MT19937-64
  (``core.rng``); ``init_states_np(seeds)`` stacks boards on the host and
  moves them to the device in one transfer.
* ``random_board`` / ``random_state`` -- exact-engine boards with the
  reference's distribution (1/7 rigid, 1/7 wood, exactly ``ceil(n_wood/2)``
  wood cells flagged, flags uniform in [1, 4]) drawn from Philox keyed by
  env key rows (see ``env.environment``); equal to JAX in distribution only.
* ``random_board_fast`` / ``random_cell_state`` -- plane-engine boards on a
  ``torch.Generator``: each wood cell carries a flag w.p. 1/2 instead.

Agents stand in the corners, in seat order or, with
``randomize_positions``, in a uniformly drawn permutation.

Replicated reference quirks of ``init_board_items_raw`` (bboard.cpp:360-380):

* ``idxSample(0, q.count)`` has an *inclusive* upper bound, so the powerup
  loop can sample one-past-the-end of the wood queue -- an uninitialised
  stack read in the reference, modelled as value 0 (cell (0, 0), a corner
  that agent placement overwrites).
* The powerup flag is drawn from [1, 4] but revealed through ``& 0b11``, so a
  drawn 4 is "empty wood".
* A cell qualifies for a flag when its low byte is 0 -- PASSAGE qualifies
  too, so the modelled out-of-range sample can corrupt cell (0, 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_AGENT0,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    NUM_CELLS,
)
from .rng import MT19937_64, UniformIntDistribution
from .state import I32, State, empty_state, map_state, put_agents_in_corners

# Reference raw Item codes (bboard.hpp:54-71), used only inside the replica.
_RAW_PASSAGE = 0
_RAW_RIGID = 1
_RAW_WOOD = 2 << 8

DEFAULT_SEED = 0x1337

# Philox streams of an env key row's reset draw (``env.environment``): cell
# classes, powerup flags, the seat permutation, and the exact generator's
# ranking of wood cells.
STREAM_ENV_CELLS, STREAM_ENV_FLAGS, STREAM_ENV_SEATS, STREAM_ENV_RANKS = \
    3, 4, 5, 6


def init_board_items_raw(seed: int = DEFAULT_SEED) -> np.ndarray:
    """Replica of ``InitBoardItems`` (bboard.cpp:345-381), raw Item codes
    (int64[NUM_CELLS]), for bit-level diffing against the reference."""
    rng = MT19937_64(seed)
    int_dist = UniformIntDistribution(0, 6)

    raw = np.zeros(NUM_CELLS, np.int64)
    wood_q: list[int] = []
    # Cells are drawn in flat-index order (bboard.cpp:352-363).
    for c in range(NUM_CELLS):
        tmp = int_dist(rng)
        # ChooseItemOuter (bboard.cpp:59-74): 1 -> rigid, 2 -> wood, else
        # passage.
        if tmp == 1:
            raw[c] = _RAW_RIGID
        elif tmp == 2:
            raw[c] = _RAW_WOOD
            wood_q.append(c)

    idx_sample = UniformIntDistribution(0, len(wood_q))  # inclusive quirk
    choose_pwp = UniformIntDistribution(1, 4)
    total = 0
    while True:
        pos = idx_sample(rng)
        # pos == len(wood_q) is the reference's uninitialised stack read,
        # modelled as slot value 0.
        idx = wood_q[pos] if pos < len(wood_q) else 0
        if (raw[idx] & 0xFF) == 0:
            raw[idx] += choose_pwp(rng)
            total += 1
        if total >= len(wood_q) / 2:
            break
    return raw


def init_board_items_np(seed: int = DEFAULT_SEED):
    """``InitBoardItems`` decoded into the plane encoding: ``(board,
    hidden_pow)`` int32 ndarrays of shape [NUM_CELLS]."""
    raw = init_board_items_raw(seed)
    board = np.zeros(NUM_CELLS, np.int32)
    hidden = np.zeros(NUM_CELLS, np.int32)
    for c in range(NUM_CELLS):
        r = int(raw[c])
        if r >> 8 == 2:  # wood (possibly with a flag in the low byte)
            board[c] = C_WOOD
            hidden[c] = r & 0xFF
        elif r == _RAW_RIGID:
            board[c] = C_RIGID
        elif r == _RAW_PASSAGE:
            board[c] = C_PASSAGE
        else:
            # Only reachable through the modelled out-of-range sample
            # corrupting a passage cell: keep it blocking, like the
            # reference's invalid item.
            board[c] = C_RIGID
    return board, hidden


def init_states_np(seeds, a0=0, a1=1, a2=2, a3=3, device=None) -> State:
    """``InitState`` (bboard.cpp:338-343) for every seed: the boards are
    drawn and stacked on the host, then moved to ``device`` (None: the
    card) in one transfer.  Returns a batch of ``len(seeds)`` boards."""
    seeds = list(seeds)
    planes = [init_board_items_np(s) for s in seeds]
    board = np.stack([p[0] for p in planes]).reshape(len(seeds), NUM_CELLS)
    hidden = np.stack([p[1] for p in planes]).reshape(len(seeds), NUM_CELLS)
    s = empty_state(len(seeds), "cpu")
    s = s._replace(board=torch.from_numpy(board),
                   hidden_pow=torch.from_numpy(hidden))
    s = put_agents_in_corners(s, a0, a1, a2, a3)
    device = resolve_device(device)
    return map_state(lambda t: t.to(device, non_blocking=True), s)


def init_state_np(seed: int = DEFAULT_SEED, a0=0, a1=1, a2=2, a3=3,
                  device=None) -> State:
    """Replica of ``InitState`` (bboard.cpp:338-343): items + corner agents,
    a batch of one board."""
    return init_states_np([seed], a0, a1, a2, a3, device)


def key_words(key, streams) -> torch.Tensor:
    """Philox words ``[n, len(streams), 31, 4]`` of the env key rows ``key``
    (i64[n, 3]: seed, board id, resets drawn): counter words (board id,
    resets drawn, stream, cell // 4)."""
    from ..engine.fused_step import philox4x32

    dev = key.device
    seed, board_id, count = (key[:, k, None, None] for k in range(3))
    stream = torch.tensor(streams, dtype=torch.int64, device=dev)[None, :, None]
    group = torch.arange((NUM_CELLS + 3) // 4, dtype=torch.int64,
                         device=dev)[None, None, :]
    return torch.stack(philox4x32(board_id, count, stream, group, seed), 3)


def cell_draws(words) -> torch.Tensor:
    """The 30-bit draws ``[n, S, 121]`` of ``key_words``' cells."""
    from ..engine.fused_step import _draw30

    n, s = words.shape[:2]
    return _draw30(words.reshape(n, s, -1)[:, :, :NUM_CELLS])


def terrain_of(tmp) -> torch.Tensor:
    """Cell classes from draws in [0, 7): 1 rigid, 2 wood, else passage."""
    board = torch.full_like(tmp, C_PASSAGE)
    board = torch.where(tmp == 1, C_RIGID, board)
    return torch.where(tmp == 2, C_WOOD, board)


def seat_perm(words) -> torch.Tensor:
    """Seat permutation ``[n, 4]`` from one stream's first four words; the
    seat index in the low bits breaks ties."""
    seat = torch.arange(AGENT_COUNT, dtype=torch.int64, device=words.device)
    return ((words[:, 0, :] & ~3) | seat).argsort(1)


def random_board(key):
    """Exact-engine ``(board, hidden_pow)`` i32[n, 121] of the key rows.

    Each cell is rigid w.p. 1/7 and wood w.p. 1/7; exactly
    ``ceil(n_wood / 2)`` wood cells carry a flag, uniform in [1, 4]: those
    of the lowest rank draws (the cell index breaks ties)."""
    draws = cell_draws(key_words(
        key, (STREAM_ENV_CELLS, STREAM_ENV_FLAGS, STREAM_ENV_RANKS)))
    board = terrain_of(draws[:, 0] % 7)
    wood = board == C_WOOD
    n_flag = (wood.sum(1, keepdim=True) + 1) // 2
    cell = torch.arange(NUM_CELLS, device=key.device)
    score = torch.where(wood, draws[:, 2].long() * NUM_CELLS + cell,
                        1 << 40)
    rank = score.argsort(1).argsort(1)
    flagged = wood & (rank < n_flag)
    hidden = torch.where(flagged, (draws[:, 1] >> 1) % 4 + 1, 0)
    return board.to(I32), hidden.to(I32)


def random_state(key, randomize_positions: bool = False) -> State:
    """Fresh exact-engine states of the key rows (agents in the corners, or
    seated by the key's permutation draw), on the key's device."""
    board, hidden = random_board(key)
    s = empty_state(key.shape[0], key.device)._replace(
        board=board, hidden_pow=hidden)
    if not randomize_positions:
        return put_agents_in_corners(s)
    return put_agents_in_corners_perm(
        s, seat_perm(key_words(key, (STREAM_ENV_SEATS,))[:, 0]))

# Corner order of ``put_agents_in_corners``: (0,0), (10,0), (10,10), (0,10).
CORNER_X = (0, BOARD_SIZE - 1, BOARD_SIZE - 1, 0)
CORNER_Y = (0, 0, BOARD_SIZE - 1, BOARD_SIZE - 1)


def random_board_fast(b: int, generator: torch.Generator):
    """(board, hidden_pow) planes i32[b, 121] on the generator's device."""
    dev = generator.device
    tmp = torch.randint(0, 7, (b, NUM_CELLS), generator=generator, device=dev)
    board = torch.full((b, NUM_CELLS), C_PASSAGE, dtype=I32, device=dev)
    board = torch.where(tmp == 1, C_RIGID, board)
    board = torch.where(tmp == 2, C_WOOD, board)
    sel = torch.rand((b, NUM_CELLS), generator=generator, device=dev) < 0.5
    flags = torch.randint(1, 5, (b, NUM_CELLS), generator=generator,
                          device=dev, dtype=I32)
    hidden = torch.where((board == C_WOOD) & sel, flags, 0)
    return board, hidden


def put_agents_in_corners_perm(cs, perm):
    """``put_agents_in_corners`` with a per-board seat assignment.

    ``perm`` is an integer tensor [B, 4]: ``perm[b, c]`` is the agent that
    stands in corner ``c`` of board ``b`` (corner order ``CORNER_X`` /
    ``CORNER_Y``).  Every row must be a permutation of 0-3.
    """
    dev = cs.board.device
    perm = perm.to(device=dev, dtype=torch.int64)
    b = perm.shape[0]
    cx = torch.tensor(CORNER_X, dtype=I32, device=dev).expand(b, -1)
    cy = torch.tensor(CORNER_Y, dtype=I32, device=dev).expand(b, -1)
    board = cs.board.clone()
    for c in range(AGENT_COUNT):
        board[:, CORNER_X[c] + BOARD_SIZE * CORNER_Y[c]] = \
            (C_AGENT0 + perm[:, c]).to(I32)
    return cs._replace(
        board=board,
        agent_x=cs.agent_x.scatter(1, perm, cx),
        agent_y=cs.agent_y.scatter(1, perm, cy),
    )


def random_cell_state(b: int, seed: int = 0, device=None,
                      generator: torch.Generator | None = None,
                      randomize_positions: bool = False):
    """Fresh plane-encoded states for ``b`` boards (agents in the corners).

    Randomness comes from ``generator`` when given, else from a new
    generator on ``device`` seeded with ``seed``.  ``randomize_positions``
    draws, per board, which agent sits in which corner (a uniform
    permutation from the generator; the reference ``MakeGame``'s optional
    shuffle); off, agent ``i`` sits in corner ``i``.
    """
    from ..engine.cellular import empty_cell_state

    if generator is None:
        device = resolve_device(device)
        generator = torch.Generator(device=device).manual_seed(seed)
    board, hidden = random_board_fast(b, generator)
    cs = empty_cell_state(b, generator.device)._replace(
        board=board, hidden_pow=hidden
    )
    if randomize_positions:
        perm = torch.rand((b, AGENT_COUNT), generator=generator,
                          device=generator.device).argsort(1)
        return put_agents_in_corners_perm(cs, perm)
    return put_agents_in_corners(cs)

"""The env layer's mixed-control step in plain PyTorch: the one-step chunk
with the learner's lanes injected, then the epilogue (done latch, terminal
detection, the Philox reset of boards that were done).

Frozen copy, not an import: ``EnvState``, ``_draw_fresh_game`` (corner
seats only), ``_fresh``, ``_detect_terminal`` (free-for-all) and
``_merge_done_and_reset`` of ``pomcpp_tpu_torch/env/environment.py``,
``key_words``, ``cell_draws`` and ``terrain_of`` of ``core/board_gen.py``
and ``empty_cell_state`` of ``engine/cellular.py``, at commit
d0a03242271a; the reset rows are drawn for every board and selected, as
the docstring of ``_merge_done_and_reset`` says gives the same result.  It
imports nothing of the port, of the JAX package or of JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .chunk import _draw30, philox4x32, rollout_chunk
from .rules import (
    AGENT_COUNT,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    I32,
    NUM_CELLS,
    CellState,
    put_agents_in_corners,
)

STREAM_ENV_CELLS, STREAM_ENV_FLAGS = 3, 4


class EnvState(NamedTuple):
    game: CellState
    done: torch.Tensor     # bool[B]
    winner: torch.Tensor   # i32[B], agent id or -1
    is_draw: torch.Tensor  # bool[B]
    key: torch.Tensor      # i64[B, 3]: seed, board id, resets drawn so far


def empty_cell_state(b: int, device) -> CellState:
    """All-passage boards, agents at (0,0), default stats."""
    zc = torch.zeros((b, NUM_CELLS), dtype=I32, device=device)
    za = torch.zeros((b, AGENT_COUNT), dtype=I32, device=device)
    zb = torch.zeros((b, AGENT_COUNT), dtype=torch.bool, device=device)
    return CellState(
        board=zc, hidden_pow=zc, flame_timer=zc, bomb_timer=zc,
        bomb_strength=zc, bomb_dir=zc, bomb_owner=zc,
        agent_x=za, agent_y=za, agent_bomb_count=za,
        agent_max_bombs=za + 1, agent_strength=za + 1,
        agent_can_kick=zb, agent_dead=zb,
        alive_count=torch.full((b,), AGENT_COUNT, dtype=I32, device=device),
        timestep=torch.zeros((b,), dtype=I32, device=device),
    )


def key_words(key, streams) -> torch.Tensor:
    """Philox words ``[n, len(streams), 31, 4]`` of the env key rows ``key``
    (i64[n, 3]: seed, board id, resets drawn): counter words (board id,
    resets drawn, stream, cell // 4)."""
    dev = key.device
    seed, board_id, count = (key[:, k, None, None] for k in range(3))
    stream = torch.tensor(streams, dtype=torch.int64, device=dev)[None, :, None]
    group = torch.arange((NUM_CELLS + 3) // 4, dtype=torch.int64,
                         device=dev)[None, None, :]
    return torch.stack(philox4x32(board_id, count, stream, group, seed), 3)


def cell_draws(words) -> torch.Tensor:
    """The 30-bit draws ``[n, S, 121]`` of ``key_words``' cells."""
    n, s = words.shape[:2]
    return _draw30(words.reshape(n, s, -1)[:, :, :NUM_CELLS])


def terrain_of(tmp) -> torch.Tensor:
    """Cell classes from draws in [0, 7): 1 rigid, 2 wood, else passage."""
    board = torch.full_like(tmp, C_PASSAGE)
    board = torch.where(tmp == 1, C_RIGID, board)
    return torch.where(tmp == 2, C_WOOD, board)


def draw_fresh_game(key) -> CellState:
    """The reset boards of the key rows ``key``, agents in the corners."""
    words = key_words(key, (STREAM_ENV_CELLS, STREAM_ENV_FLAGS))
    draws = cell_draws(words)
    tmp, flags = draws[:, 0] % 7, draws[:, 1]
    board = terrain_of(tmp)
    hidden = torch.where(
        (board == C_WOOD) & ((flags & 1) == 0), (flags >> 1) % 4 + 1, 0
    )
    cs = empty_cell_state(key.shape[0], key.device)._replace(
        board=board, hidden_pow=hidden)
    return put_agents_in_corners(cs)


def fresh_env(key) -> EnvState:
    """Fresh games for the key rows, their reset count advanced."""
    n, dev = key.shape[0], key.device
    step = torch.tensor([0, 0, 1], dtype=torch.int64, device=dev)
    return EnvState(
        game=draw_fresh_game(key),
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        winner=torch.full((n,), -1, dtype=I32, device=dev),
        is_draw=torch.zeros(n, dtype=torch.bool, device=dev),
        key=key + step,
    )


def detect_terminal(es: EnvState, max_steps: int = 0) -> EnvState:
    """Free-for-all win/draw latching after a step: the last agent standing
    wins, nobody alive is a draw, and ``max_steps > 0`` ends a game as a
    draw once ``timestep`` reaches it."""
    dead = es.game.agent_dead
    won = es.game.alive_count == 1
    survivor = (~dead).to(I32).argmax(1).to(I32)
    draw = es.game.alive_count == 0
    if max_steps:
        draw = draw | (~won & (es.game.timestep >= max_steps))
    return es._replace(
        done=es.done | won | draw,
        winner=torch.where(won & ~es.done, survivor, es.winner),
        is_draw=es.is_draw | (draw & ~es.done),
    )


def where_env(mask, a: EnvState, b: EnvState) -> EnvState:
    """Per board: ``a`` where ``mask`` else ``b``, over every field."""
    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return EnvState(CellState(*map(pick, a.game, b.game)),
                    *map(pick, a[1:], b[1:]))


def merge_done_and_reset(es: EnvState, game: CellState,
                         max_steps: int) -> EnvState:
    """The epilogue: ``game`` is the stepped batch, timestep advanced; a
    board done before the step takes a fresh game keyed from ``es.key``,
    the others latch their result."""
    nxt = detect_terminal(es._replace(game=game), max_steps)
    return where_env(es.done, fresh_env(es.key), nxt)


def mixed_step(es: EnvState, learner_moves, fsm_state, learner_slots,
               seeds, boards, max_steps: int,
               move_rounds: int = AGENT_COUNT):
    """One mixed-control env step (``env_step_auto_reset_batch_fsm``): the
    SimpleAgent acts in the lanes outside ``learner_slots`` with rands
    drawn from Philox under ``seeds``, the learner lanes take
    ``learner_moves`` (i32[B, 4]) -> ``(EnvState, fsm_state')``."""
    game, fsm = rollout_chunk(
        es.game, seeds, boards, 1, "simple", fsm_state=fsm_state,
        moves=learner_moves[None], inject_slots=tuple(learner_slots),
        prng_rand=True, auto_reset=False, move_rounds=move_rounds)
    return merge_done_and_reset(es, game, max_steps), fsm

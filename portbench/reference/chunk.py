"""The chunk of self-play steps in plain PyTorch: Philox draws, fresh
terrain, the pipelined auto-reset and the SimpleAgent's act per step.

Frozen copy, not an import: ``philox4x32``, ``_draw30``, ``draw_moves``,
``fresh_terrain``, ``_fresh_state``, ``_merge``, ``_fresh_fsm`` and
``rollout_chunk_plain`` of ``pomcpp_tpu_torch/engine/fused_step.py`` at
commit d0a03242271a.  Two changes, neither of the arithmetic: a board's
Philox key and its index in the program's batch are per-board tensors
(``seeds``, ``boards``), so that boards sampled from several chunks of a
run step together in one batch; and ``move_rounds`` reaches the step
(``rules.cellular_step``).  It imports nothing of the port, of the JAX
package or of JAX.
"""

from __future__ import annotations

import torch

from .rules import (
    AGENT_COUNT,
    AGENT_FIELDS,
    BOARD_SIZE,
    C_AGENT0,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    I32,
    NUM_CELLS,
    PLANE_FIELDS,
    CellState,
    cellular_step,
)
from .simple_agent import RP_STALE, FsmState, fsm_act

MAX_CHAIN_ROUNDS = 4
POLICY_MOVES = {"harmless": 5, "random": 6, "simple": 5}
STREAM_MOVES, STREAM_CELLS, STREAM_FLAGS = 0, 1, 2
CORNERS = (0, BOARD_SIZE - 1, NUM_CELLS - 1, NUM_CELLS - BOARD_SIZE)

_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and int64 b in [0, 2^32),
    without overflowing int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed):
    """Philox4x32-10 output words (int64 tensors holding uint32 values).

    The counter words broadcast against each other and are taken mod 2^32;
    ``seed`` gives the key and is a Python int or a non-negative int64
    tensor that broadcasts against the counter words (one key per element).
    """
    device = next((c.device for c in (c0, c1, c2, c3)
                   if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = (
        torch.as_tensor(c, dtype=torch.int64, device=device) & _MASK32
        for c in (c0, c1, c2, c3)
    )
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _draw30(word):
    return ((word >> 1) & 0x3FFFFFFF).to(I32)


def draw_moves(seeds, boards, step: int, n_moves: int) -> torch.Tensor:
    """i32[B, 4] draws of one chunk-local step; ``seeds`` and ``boards``
    are i64[B]."""
    words = philox4x32(boards, step, STREAM_MOVES, 0, seeds)
    return torch.stack([_draw30(w) % n_moves for w in words], 1)


def fresh_terrain(seeds, boards):
    """(board, hidden_pow) i32[B, 121] replacement terrain of one chunk."""
    group = torch.arange((NUM_CELLS + 3) // 4, dtype=torch.int64,
                         device=boards.device)[None, :]
    b = boards.shape[0]

    def cells(stream):
        words = philox4x32(boards[:, None], 0, stream, group, seeds[:, None])
        return _draw30(torch.stack(words, 2).reshape(b, -1)[:, :NUM_CELLS])

    tmp = cells(STREAM_CELLS) % 7
    flags = cells(STREAM_FLAGS)
    board = torch.full_like(tmp, C_PASSAGE)
    board = torch.where(tmp == 1, C_RIGID, board)
    board = torch.where(tmp == 2, C_WOOD, board)
    hidden = torch.where(
        (board == C_WOOD) & ((flags & 1) == 0), (flags >> 1) % 4 + 1, 0
    )
    return board, hidden


def finished(dead):
    """bool[B]: at most one agent alive."""
    return dead.sum(1) >= AGENT_COUNT - 1


def with_counts(out: CellState, timestep) -> CellState:
    alive = AGENT_COUNT - out.agent_dead.sum(1, dtype=I32)
    return out._replace(alive_count=alive, timestep=timestep)


def _fresh_state(board, hidden) -> CellState:
    """Reset state: terrain plus corner agents, zeroed dynamics."""
    b = board.shape[0]
    board = board.to(I32).clone()
    for i, c in enumerate(CORNERS):
        board[:, c] = C_AGENT0 + i
    zero = torch.zeros_like(board)
    z4 = torch.zeros((b, AGENT_COUNT), dtype=I32, device=board.device)
    ax = torch.tensor([0, BOARD_SIZE - 1, BOARD_SIZE - 1, 0], dtype=I32,
                      device=board.device).expand(b, -1)
    ay = torch.tensor([0, 0, BOARD_SIZE - 1, BOARD_SIZE - 1], dtype=I32,
                      device=board.device).expand(b, -1)
    return CellState(
        board, hidden.to(I32), zero, zero, zero, zero, zero,
        ax, ay, z4, z4 + 1, z4 + 1, z4 != 0, z4 != 0,
        z4[:, 0] + AGENT_COUNT, z4[:, 0],
    )


def _merge(fresh: CellState, cs: CellState, done) -> CellState:
    """Replace the done boards' 14 kernel-side fields with fresh state."""
    merged = {}
    for name in PLANE_FIELDS + AGENT_FIELDS:
        merged[name] = torch.where(
            done[:, None], getattr(fresh, name), getattr(cs, name)
        )
    return cs._replace(**merged)


def _fresh_fsm(fsm: FsmState, done) -> FsmState:
    """Reset the done boards' FSM state: ring slots 14, count and moveQueue
    slots 0 (the head is 0 throughout)."""
    d = done[:, None]
    return FsmState(*(
        torch.where(d, RP_STALE if k < 4 else 0, t).to(I32)
        for k, t in enumerate(fsm)
    ))


def rollout_chunk(cs: CellState, seeds, boards, steps: int,
                  policy: str = "random", fsm_state=None, moves=None,
                  inject_slots=(), prng_rand: bool = False,
                  auto_reset: bool = True, move_rounds: int = AGENT_COUNT):
    """``steps`` self-play steps of ``policy`` for boards keyed by ``seeds``
    and numbered ``boards`` (i64[B] each) -> the new state, and with
    ``policy="simple"`` the FSM state too.  The semantics are those of the
    port's ``rollout_chunk``: reset latency 2, one catch-up merge after the
    loop, terrain drawn once a chunk, ``timestep`` advanced by ``steps``.
    ``moves`` (i32[steps, B, 4]) with ``inject_slots`` is the mixed-control
    mode's override; the FSM's rands then come from ``moves`` unless
    ``prng_rand``."""
    n_moves = POLICY_MOVES[policy]
    b, dev = cs.board.shape[0], cs.board.device
    if auto_reset:
        fresh = _fresh_state(*fresh_terrain(seeds, boards))
        done = finished(cs.agent_dead)
    else:
        done = torch.zeros(b, dtype=torch.bool, device=dev)
    state, fsm = cs, fsm_state
    if fsm is not None:
        fsm = FsmState(*fsm)._replace(rp_head=torch.zeros_like(fsm[4]))
    override = torch.zeros(AGENT_COUNT, dtype=torch.bool, device=dev)
    override[list(inject_slots)] = True
    for t in range(steps):
        drawn = moves[t] if moves is not None and not prng_rand else \
            draw_moves(seeds, boards, t, n_moves)
        done_next = done
        if auto_reset:
            state = _merge(fresh, state, done)
            if fsm is not None:
                fsm = _fresh_fsm(fsm, done)
            done_next = finished(state.agent_dead)
        if fsm is not None:
            mv, fsm = fsm_act(state, fsm, drawn)
            if inject_slots:
                mv = torch.where(override, moves[t], mv)
            mv = torch.where(state.agent_dead, 0, mv)
        else:
            mv = drawn
        state = cellular_step(state, mv, MAX_CHAIN_ROUNDS, move_rounds)
        done = done_next
    if auto_reset:
        last = finished(state.agent_dead)
        state = _merge(fresh, state, last)
        if fsm is not None:
            fsm = _fresh_fsm(fsm, last)
    out = with_counts(state, cs.timestep + steps)
    return out if fsm is None else (out, fsm)

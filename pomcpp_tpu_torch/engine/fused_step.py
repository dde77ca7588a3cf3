"""The fused step and chunk kernels of the port, with their plain versions.

Counterpart of ``pomcpp_tpu.engine.pallas_step``.  Two entry points:

* ``fused_step(cs, moves)`` -- one step for a batch of boards
  (``pallas_step``).  Plain version: ``fused_step_plain``, which is
  ``cellular_step`` with explosion chains capped at ``MAX_CHAIN_ROUNDS = 4``
  rounds per step; deeper same-step chains leave their remaining bombs
  (timers already ticked) for later steps.
* ``rollout_chunk(cs, seed, steps, policy)`` -- ``steps`` self-play steps
  in one launch (``pallas_rollout_chunk``) for the ``harmless`` (moves drawn
  ``% 5``), ``random`` (``% 6``, bombs included) and ``simple`` (the
  SimpleAgent FSM of ``engine/fsm.py`` acting for all four agents, its
  rands drawn ``% 5``) policies, with the pipelined auto-reset.  Plain
  version: ``rollout_chunk_plain``.

On a CUDA device an entry point launches its kernel (``csrc/fused_step.cu``)
through ``launch.fused_step`` / ``launch.chunk``, which count it in
``_ext.LAUNCHES``; on the CPU it runs the plain version.  ``launch.card``
chooses, and there is no fallback between the two.  The simple chunk is its
own template instantiation of the chunk kernel and has its own launch count,
``rollout_chunk_simple_kernel``.  ``rollout_chunk`` carries the spans
``chunk`` -> ``chunk.args``, ``chunk.launch``, ``chunk.out`` of ``trace``;
while tracing is on, one launcher call in ``trace.SAMPLE_EVERY`` launches
the clocked instance (``rollout_chunk_clocked_kernel``, counted as
``rollout_chunk_clocked_kernel`` / ``rollout_chunk_clocked_simple_kernel``),
which writes the call's phase totals.

PRNG.  The TPU kernel's in-kernel generator cannot be reproduced off the
TPU, so the port draws from Philox4x32-10 (Random123's
``philox4x32_10``), written twice with the same formula: in the CUDA kernel
and in torch integer ops below.  The key is ``(seed mod 2^32,
(seed >> 32) mod 2^32)``.  Counter words ``(c0, c1, c2, c3)``:

* moves: ``(board, chunk-local step, 0, 0)``; output word ``i`` is agent
  ``i``'s draw;
* fresh terrain, cell class: ``(board, 0, 1, cell // 4)``, word
  ``cell % 4``;
* fresh terrain, powerup flag: ``(board, 0, 2, cell // 4)``, word
  ``cell % 4``.

A draw is the non-negative 30-bit value ``(word >> 1) & 0x3FFFFFFF``, as
the TPU kernel takes it; moves are that value modulo the policy's move
count.  ``board`` is the board's index in the batch.  Kernel and plain
version therefore agree bit for bit, in-kernel draws and auto-reset
included; parity with the JAX package goes through the ``moves=`` and
``reset_boards=`` injection hooks.
"""

from __future__ import annotations

import torch

from .. import launch, trace
from ..core.constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    C_AGENT0,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    NUM_CELLS,
)
from ..core.state import I32
from ..device import resolve_device
from ..agents.simple import RP_STALE, FsmState
from .cellular import AGENT_FIELDS, PLANE_FIELDS, CellState, cellular_step
from ..launch import chunk_args
from .fsm import fsm_act_plain

MAX_CHAIN_ROUNDS = 4
STREAM_MOVES, STREAM_CELLS, STREAM_FLAGS = 0, 1, 2
CORNERS = (0, BOARD_SIZE - 1, NUM_CELLS - 1, NUM_CELLS - BOARD_SIZE)

_MASK32 = 0xFFFFFFFF


# --- Philox4x32-10 in torch integer ops ---------------------------------------


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and int64 b in [0, 2^32),
    without overflowing int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 output words (int64 tensors holding uint32 values).

    The counter words broadcast against each other and are taken mod 2^32,
    as the kernels' ``uint32_t`` casts take them; ``seed`` gives the key
    and is a Python int or a non-negative int64 tensor that broadcasts
    against the counter words (one key per element).
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


def draw_moves(seed: int, step: int, b: int, n_moves: int, device) -> torch.Tensor:
    """i32[b, 4] moves of one chunk-local step, as the chunk kernel draws."""
    board = torch.arange(b, dtype=torch.int64, device=device)
    words = philox4x32(board, step, STREAM_MOVES, 0, seed)
    return torch.stack([_draw30(w) % n_moves for w in words], 1)


def fresh_terrain(seed: int, b: int, device):
    """(board, hidden_pow) i32[b, 121] replacement terrain of one chunk."""
    board_idx = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    group = torch.arange((NUM_CELLS + 3) // 4, dtype=torch.int64,
                         device=device)[None, :]

    def cells(stream):
        words = philox4x32(board_idx, 0, stream, group, seed)
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


# --- Plain versions ------------------------------------------------------------


def _finished(dead):
    """bool[B]: at most one agent alive."""
    return dead.sum(1) >= AGENT_COUNT - 1


def _with_counts(out: CellState, timestep) -> CellState:
    alive = AGENT_COUNT - out.agent_dead.sum(1, dtype=I32)
    return out._replace(alive_count=alive, timestep=timestep)


def fused_step_plain(cs: CellState, moves) -> CellState:
    """``cellular_step`` with the kernels' chain cap; ``alive_count`` is
    recounted from ``agent_dead`` and ``timestep`` kept, as ``pallas_step``
    does."""
    out = cellular_step(cs, moves, max_chain_rounds=MAX_CHAIN_ROUNDS)
    return _with_counts(out, cs.timestep)


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


def rollout_chunk_plain(cs: CellState, seed: int, steps: int,
                        policy: str = "random", moves=None,
                        record: bool = False, auto_reset: bool = True,
                        reset_boards=None, fsm_state=None,
                        inject_slots=(), prng_rand: bool = False):
    """Plain version of the chunk kernel (see ``rollout_chunk``)."""
    n_moves = chunk_args(policy, moves, fsm_state, inject_slots)
    b, dev = cs.board.shape[0], cs.board.device
    if auto_reset:
        terrain = reset_boards if reset_boards is not None else \
            fresh_terrain(seed, b, dev)
        fresh = _fresh_state(*terrain)
        done = _finished(cs.agent_dead)
    else:
        done = torch.zeros(b, dtype=torch.bool, device=dev)
    state, fsm = cs, fsm_state
    if fsm is not None:
        fsm = FsmState(*fsm)._replace(rp_head=torch.zeros_like(fsm[4]))
    override = torch.zeros(AGENT_COUNT, dtype=torch.bool, device=dev)
    override[list(inject_slots)] = True
    rec_moves, rec_done = [], []
    for t in range(steps):
        drawn = moves[t] if moves is not None and not prng_rand else \
            draw_moves(seed, t, b, n_moves, dev)
        done_next = done
        if auto_reset:
            state = _merge(fresh, state, done)
            if fsm is not None:
                fsm = _fresh_fsm(fsm, done)
            done_next = _finished(state.agent_dead)
        if fsm is not None:
            mv, fsm = fsm_act_plain(state, fsm, drawn)
            if inject_slots:
                mv = torch.where(override, moves[t], mv)
            mv = torch.where(state.agent_dead, 0, mv)
        else:
            mv = drawn
        state = cellular_step(state, mv, max_chain_rounds=MAX_CHAIN_ROUNDS)
        if record:
            rec_moves.append(mv.to(I32))
            rec_done.append(_finished(state.agent_dead))
        done = done_next
    if auto_reset:
        last = _finished(state.agent_dead)
        state = _merge(fresh, state, last)
        if fsm is not None:
            fsm = _fresh_fsm(fsm, last)
    out = (_with_counts(state, cs.timestep + steps),)
    if record:
        out += (torch.stack(rec_moves), torch.stack(rec_done))
    if fsm is not None:
        out += (fsm,)
    return out if len(out) > 1 else out[0]


# --- Entry points ----------------------------------------------------------------


def _to_device(cs: CellState, device) -> CellState:
    out = CellState(*(t.to(device) for t in cs))
    trace.count_copies(cs, out)
    return out


def fused_step(cs: CellState, moves, device=None) -> CellState:
    """One fused step for a batch: ``cs`` planes [B, 121], ``moves`` [B, 4].

    ``device=None`` runs the CUDA kernel on the card; ``device="cpu"`` the
    plain version.  ``alive_count`` is recounted from ``agent_dead`` and
    ``timestep`` is kept, as in ``pallas_step``.
    """
    device = resolve_device(device)
    card = launch.card(device)
    if card:
        return launch.fused_step(*card, cs, moves)
    cs = _to_device(cs, device)
    return fused_step_plain(cs, torch.as_tensor(moves).to(device=device,
                                                          dtype=I32))


def rollout_chunk(cs: CellState, seed: int, steps: int, policy: str = "random",
                  moves=None, record: bool = False, auto_reset: bool = True,
                  reset_boards=None, device=None, fsm_state=None,
                  inject_slots=(), prng_rand: bool = False):
    """Run ``steps`` self-play steps of ``policy`` in one kernel launch.

    Counterpart of ``pallas_rollout_chunk``.  Each step draws four 30-bit
    Philox values (``% 5`` for harmless and simple, ``% 6`` for random),
    merges fresh boards into boards that were finished at the head of the
    previous step (reset latency 2; the first mask comes from the input
    state), picks the moves and runs the fused step.  For harmless and
    random the draws are the moves (dead agents' draws are not zeroed).
    For ``policy="simple"`` they are the FSM's rands: the FSM acts for all
    four agents (dead ones included, its ring pushing its own move), the
    ``inject_slots`` lanes then take ``moves[t]``, and dead agents' moves
    are zeroed.  One catch-up merge after the loop leaves every finished
    board reset; a merge also resets that board's FSM state.  Replacement
    terrain is drawn once per chunk per board, so a board that resets twice
    in one chunk gets the same layout both times.  ``timestep`` advances by
    ``steps``; ``alive_count`` is recounted from ``agent_dead``.

    ``policy="simple"`` takes ``fsm_state`` (ten i32[B, 4] arrays, e.g.
    ``simple_fsm_state_init(B)``) and returns ``(CellState, [moves, done,]
    fsm_state')``, the new state with ring head 0.  ``inject_slots``
    (mixed control) makes ``moves`` a per-agent override; the FSM's rands
    then come from ``moves[t]`` in every lane unless ``prng_rand`` is set,
    which draws them from Philox.

    Test hooks: ``moves`` (i32[steps, B, 4]) replaces the draws,
    ``reset_boards`` (a ``(board, hidden_pow)`` pair of i32[B, 121]) the
    fresh terrain, and ``record=True`` also returns the moves taken
    (i32[steps, B, 4]) and the end-of-step done mask (bool[steps, B]).
    """
    span = trace.ON and trace.begin("chunk")
    try:
        if span:
            trace.phase("chunk.args")
        inject_slots = tuple(inject_slots)
        if reset_boards is not None and not auto_reset:
            raise ValueError("reset_boards is the auto-reset test hook")
        device = resolve_device(device)
        card = launch.card(device)
        if card:
            return launch.chunk(*card, cs, seed, steps, policy, moves, record,
                                auto_reset, reset_boards, fsm_state,
                                inject_slots, prng_rand)
        cs = _to_device(cs, device)
        if moves is not None:
            mv = torch.as_tensor(moves).to(device=device, dtype=I32)
            trace.COUNTERS["wrapper_ops"] += mv is not moves
            moves = mv
        if reset_boards is not None:
            rb = tuple(torch.as_tensor(r).to(device=device, dtype=I32)
                       for r in reset_boards)
            trace.count_copies(reset_boards, rb)
            reset_boards = rb
        if fsm_state is not None:
            fsm = FsmState(*(torch.as_tensor(t).to(device=device, dtype=I32)
                             for t in fsm_state))
            trace.count_copies(fsm_state, fsm)
            fsm_state = fsm
        if span:
            trace.phase("chunk.launch")
        return rollout_chunk_plain(cs, seed, steps, policy, moves, record,
                                   auto_reset, reset_boards, fsm_state,
                                   inject_slots, prng_rand)
    finally:
        if span:
            trace.end(span)

"""Flame spawning, chained explosions, and flame/bomb ticking, batched.

Counterpart of ``pomcpp_tpu.engine.flames`` (reference bboard.cpp:24-57,
148-263 and step_utility.cpp:208-245).  The reference's recursion
(SpawnFlameItem -> ExplodeBombAt -> SpawnFlame -> ...) runs as the JAX
package runs it: a depth-first traversal over an explicit stack of depth
``MAX_BOMBS + 2``, one ray cell per iteration, rays in the order +x, -x,
+y, -y, and a frame that waits on a chained explosion resumes by
overwriting the cell with its own signature (``pending``).

Per-board loops.  Each ``lax.while_loop`` of the JAX code becomes a masked
iteration over the batch (``masked_loop``): a board whose condition is
false is left bit for bit unchanged, and the loop ends when no board is
active, which the host reads before every iteration.  Both arms of a
``lax.cond`` are computed and the result selected per board, writes
included (every write takes the arm's mask); an arm that is rare (a ray
meeting a bomb or an agent) runs only when a host read says some board
takes it.

The stack is one int32 tensor ``[B, D, 6]`` (origin x, origin y, strength,
ray, ray step, pending) so that a frame is read and written by one gather
and one scatter.  ``tick_bombs`` runs its sweep and the traversals of the
bombs it explodes as ONE loop: an iteration either advances a board's
traversal or, when its stack is empty, explodes its next front bomb --
the same sequence per board as the JAX nesting, in max-over-boards of the
summed traversal lengths instead of their sum of maxima.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..core import queue as q
from ..core.constants import (
    BOARD_SIZE,
    C_AGENT0,
    C_BOMB,
    C_FLAME,
    C_RIGID,
    C_WOOD,
    FLAME_LIFETIME,
    MAX_BOMBS,
    MAX_FLAMES,
    NUM_CELLS,
)
from ..core.state import (
    Flames,
    I32,
    State,
    add_at,
    dropping_index,
    flag_item,
    get_bomb_index,
    index_col,
    is_agent,
    pop_bomb,
    read_at,
    read_clamped,
    remove_bomb,
    write_at,
)

STACK_DEPTH = MAX_BOMBS + 2
# Ray order of SpawnFlame: right (+x), left (-x), then +y, then -y.
_RAY_DX = (1, -1, 0, 0)
_RAY_DY = (0, 0, 1, -1)
# A traversal visits at most 4 rays x (10 cells + 1 stop) + 1 pop per frame.
_DFS_CAP = STACK_DEPTH * (4 * (BOARD_SIZE + 1) + 1)

def any_active(mask: torch.Tensor) -> bool:
    """``mask.any()`` read on the host, counted in ``trace``'s
    ``host_reads`` (the census's host-reads-per-step figure)."""
    trace.COUNTERS["host_reads"] += 1
    return bool(mask.any())


def any_flags(*masks) -> list[bool]:
    """``[m.any() for m in masks]`` in ONE host read (counted)."""
    trace.COUNTERS["host_reads"] += 1
    return torch.stack([m.any() for m in masks]).tolist()


def masked_loop(step, carry, active_of, cap: int):
    """Run ``carry = step(carry)`` while any board is active, at most
    ``cap`` times.  ``step`` must leave inactive boards as they were; the
    host reads ``active_of(carry).any()`` before every iteration (a read
    costs less than the extra iterations of reading every few: the loops
    mostly need one to three)."""
    for _ in range(cap):
        if not any_active(active_of(carry)):
            break
        carry = step(carry)
    return carry


class DfsStack(NamedTuple):
    frames: torch.Tensor  # i32[B, STACK_DEPTH, 6]
    sp: torch.Tensor      # i32[B] frames on the stack


def masked_kill(state: State, agent_id, do) -> State:
    """State::Kill (bboard.hpp:474-481) gated by ``do`` (per board)."""
    was_dead = read_at(state.agent_dead, agent_id)
    return state._replace(
        agent_dead=write_at(state.agent_dead, agent_id, True, do),
        alive_count=state.alive_count - (do & ~was_dead).to(I32),
    )


def _kill_agent_on_cell(state: State, item, mask) -> State:
    """Kill the agent encoded in a board cell value, if any (bboard.cpp:26-29)."""
    on = is_agent(item) & mask
    return masked_kill(state, torch.where(on, item - C_AGENT0, 0), on)


def _flame_origin(state: State, x, y, strength, mask) -> State:
    """Common origin handling of SpawnFlame (bboard.cpp:198-218): append the
    flame record, kill any agent on the origin, stamp the origin cell with
    this flame's signature (powerup flag cleared)."""
    flames, _, count = q.append(
        state.flames, Flames(x=x, y=y, timer=FLAME_LIFETIME, strength=strength),
        state.flame_head, state.flame_count, MAX_FLAMES, mask)
    state = state._replace(flames=flames, flame_count=count)
    # The origin comes from a bomb's stored position: JAX's clamped read
    # and wrap-or-drop writes (``core.state``).
    c = x + BOARD_SIZE * y
    state = _kill_agent_on_cell(state, read_clamped(state.board, c), mask)
    idx, ok = dropping_index(c, NUM_CELLS, c.shape[0], mask)
    idx = index_col(idx)
    return state._replace(
        board=write_at(state.board, idx, C_FLAME, ok),
        flame_sig=write_at(state.flame_sig, idx, c, ok),
        hidden_pow=write_at(state.hidden_pow, idx, 0, ok),
    )


def _frame(x, y, strength):
    """A fresh stack frame ``[B, 6]``: ray 0, step 1, not pending."""
    z = torch.zeros_like(x)
    return torch.stack([x, y, strength, z, z + 1, z], 1).to(I32)


def _push(stk: DfsStack, frame, mask) -> DfsStack:
    """Push ``frame`` where ``mask``.  ``_stack_set(stk, sp, ...)`` at
    ``sp == STACK_DEPTH`` is dropped in JAX while ``sp`` still grows: the
    write is masked the same way (a chain cannot reach that depth)."""
    sp = stk.sp
    ok = mask & (sp < STACK_DEPTH)
    idx = sp.clamp(0, STACK_DEPTH - 1).long()[:, None, None].expand(-1, 1, 6)
    old = stk.frames.gather(1, idx)[:, 0]
    new = torch.where(ok[:, None], frame, old)
    return DfsStack(stk.frames.scatter(1, idx, new[:, None]),
                    sp + mask.to(I32))


def _new_stack(b: int, device) -> DfsStack:
    return DfsStack(torch.zeros((b, STACK_DEPTH, 6), dtype=I32, device=device),
                    torch.zeros(b, dtype=I32, device=device))


def _dfs_step(carry):
    """One iteration of the traversal (``_dfs_body``) on every board whose
    stack is not empty; the others are left as they are."""
    state, stk = carry
    dev = state.board.device
    active = stk.sp > 0
    t = (stk.sp - 1).clamp(min=0).long()[:, None, None].expand(-1, 1, 6)
    fr = stk.frames.gather(1, t)[:, 0]
    ox, oy, strength, dr, ri, pend = fr.unbind(1)
    d = dr.clamp(0, 3).long()
    cx = ox + ri * torch.tensor(_RAY_DX, dtype=I32, device=dev)[d]
    cy = oy + ri * torch.tensor(_RAY_DY, dtype=I32, device=dev)[d]
    sig = ox + BOARD_SIZE * oy
    c = cx.clamp(0, 10) + BOARD_SIZE * cy.clamp(0, 10)
    oob = (cx < 0) | (cy < 0) | (cx > 10) | (cy > 10)

    pending = active & (pend != 0)
    frame_done = active & ~pending & (dr >= 4)
    go = active & ~pending & ~frame_done
    on_oob = go & oob
    on_cell = go & ~oob

    ci = index_col(c)
    item = read_at(state.board, ci)
    bomb_idx = get_bomb_index(state, cx, cy)
    chained = on_cell & ((item == C_BOMB) | is_agent(item)) & (bomb_idx >= 0)
    burn = on_cell & ~chained
    rigid = burn & (item == C_RIGID)
    burnable = burn & ~rigid
    was_wood = item == C_WOOD
    pow_flag = torch.where(burnable & was_wood, read_at(state.hidden_pow, ci),
                           0)
    # A ray that meets an agent or a bomb is rare: one host read tells
    # whether any board does, and the arms are skipped where none does.
    any_kill, any_chain = any_flags(on_cell & is_agent(item), chained)
    if any_kill:
        state = _kill_agent_on_cell(state, item, on_cell)

    sig_written = sig
    stg2 = None
    if any_chain:
        # Chained: ExplodeBombAt (bboard.cpp:111-118) with the owner's LIVE
        # strength; the bomb index is -1 only where ``chained`` is False,
        # and the owner read of that stale slot is discarded.  The origin's
        # own kill is the one just made (same cell, same item).
        bid = q.get(state.bombs.id, state.bomb_head, bomb_idx)
        stg2 = read_at(state.agent_strength, bid)
        state = remove_bomb(state, bomb_idx, chained)
        flames, _, fcount = q.append(
            state.flames,
            Flames(x=cx, y=cy, timer=FLAME_LIFETIME, strength=stg2),
            state.flame_head, state.flame_count, MAX_FLAMES, chained)
        state = state._replace(
            agent_bomb_count=add_at(state.agent_bomb_count, bid, -1, chained),
            flames=flames, flame_count=fcount)
        sig_written = torch.where(chained, c, sig)
    # One write of cell c serves three arms: the resumed frame (our
    # signature, flag 0), a burnt cell (our signature, wood's flag) and the
    # chained origin (its own signature, flag 0).
    write = pending | burnable | chained
    state = state._replace(
        board=write_at(state.board, ci, C_FLAME, write),
        flame_sig=write_at(state.flame_sig, ci, sig_written, write),
        hidden_pow=write_at(state.hidden_pow, ci, pow_flag, write),
    )

    # Frame t: advance the ray (resumed frame, burnt cell: wood stops it),
    # next ray (off the board, rigid), or wait on the chained explosion.
    adv = pending | burnable
    nxt = ri + 1
    adone = (burnable & was_wood) | (nxt > strength)
    turn = (adv & adone) | on_oob | rigid
    new = torch.stack([
        ox, oy, strength,
        torch.where(turn, dr + 1, dr),
        torch.where(turn, 1, torch.where(adv, nxt, ri)),
        torch.where(chained, 1, torch.where(pending, 0, pend)),
    ], 1).to(I32)
    frames = stk.frames.scatter(1, t, new[:, None])
    stk = DfsStack(frames, stk.sp - frame_done.to(I32))
    if any_chain:
        stk = _push(stk, _frame(cx, cy, stg2), chained)
    return state, stk


def _run_dfs(state: State, stk: DfsStack) -> State:
    state, _ = masked_loop(_dfs_step, (state, stk), lambda c: c[1].sp > 0,
                           _DFS_CAP)
    return state


def spawn_flame(state: State, x, y, strength, mask=None) -> State:
    """State::SpawnFlame (bboard.cpp:198-263) incl. chained explosions, on
    the boards of ``mask`` (all when None)."""
    dev = state.board.device
    b = state.board.shape[0]
    mask = torch.ones(b, dtype=torch.bool, device=dev) if mask is None else mask
    x, y, strength = (torch.as_tensor(v, device=dev).to(I32).expand(b)
                      for v in (x, y, strength))
    state = _flame_origin(state, x, y, strength, mask)
    stk = _push(_new_stack(b, dev), _frame(x, y, strength), mask)
    return _run_dfs(state, stk)


def explode_bomb_at(state: State, i, mask=None) -> State:
    """State::ExplodeBombAt (bboard.cpp:111-118): live owner strength."""
    b = state.board.shape[0]
    if mask is None:
        mask = torch.ones(b, dtype=torch.bool, device=state.board.device)
    bx, by, bid = q.get_many((state.bombs.x, state.bombs.y, state.bombs.id),
                             state.bomb_head, i)
    strength = read_at(state.agent_strength, bid)
    state = remove_bomb(state, i, mask)
    state = state._replace(
        agent_bomb_count=add_at(state.agent_bomb_count, bid, -1, mask))
    return spawn_flame(state, bx, by, strength, mask)


def _start_top_bomb(state: State, stk: DfsStack, mask):
    """ExplodeTopBomb (bboard.cpp:191-196) up to its traversal: stored
    strength, PopBomb, the flame origin and its frame pushed."""
    b = state.bombs
    bx, by, strength = q.get_many((b.x, b.y, b.strength), state.bomb_head, 0)
    state = pop_bomb(state, mask)
    state = _flame_origin(state, bx, by, strength, mask)
    return state, _push(stk, _frame(bx, by, strength), mask)


def explode_top_bomb(state: State, mask=None) -> State:
    """State::ExplodeTopBomb (bboard.cpp:191-196): stored strength, PopBomb."""
    b = state.board.shape[0]
    if mask is None:
        mask = torch.ones(b, dtype=torch.bool, device=state.board.device)
    state, stk = _start_top_bomb(state, _new_stack(b, state.board.device),
                                 mask)
    return _run_dfs(state, stk)


def pop_flame(state: State, mask=None) -> State:
    """State::PopFlame (bboard.cpp:148-180) on the boards of ``mask``.

    Clears only cells whose signature matches this flame's origin
    ("only vanish your own flame"), revealing hidden powerups via FlagItem.
    """
    h = state.flame_head
    fx = q.get(state.flames.x, h, 0)[:, None]
    fy = q.get(state.flames.y, h, 0)[:, None]
    s = q.get(state.flames.strength, h, 0)[:, None]
    sig = fx + BOARD_SIZE * fy
    idx = torch.arange(NUM_CELLS, device=fx.device)
    x, y = idx % BOARD_SIZE, idx // BOARD_SIZE
    in_cross = (((y == fy) & ((x - fx).abs() <= s))
                | ((x == fx) & ((y - fy).abs() <= s)))
    mine = in_cross & (state.board == C_FLAME) & (state.flame_sig == sig)
    if mask is not None:
        mine = mine & mask[:, None]
    head, count = q.pop_front(h, state.flame_count, MAX_FLAMES, mask)
    return state._replace(
        board=torch.where(mine, flag_item(state.hidden_pow), state.board),
        flame_sig=torch.where(mine, 0, state.flame_sig),
        hidden_pow=torch.where(mine, 0, state.hidden_pow),
        flame_head=head, flame_count=count,
    )


def _valid_slots(head, count, n: int):
    r = (torch.arange(n, device=head.device) - head[:, None]) % n
    return r < count[:, None]


def tick_flames(state: State) -> State:
    """util::TickFlames (step_utility.cpp:208-222).

    All flame timers decrement; front flames reaching 0 are popped (flames
    are queued in creation order with equal lifetimes, so the front holds
    the minimum timer)."""
    valid = _valid_slots(state.flame_head, state.flame_count, MAX_FLAMES)
    timer = torch.where(valid, state.flames.timer - 1, state.flames.timer)
    state = state._replace(flames=state.flames._replace(timer=timer))

    def front_done(s):
        return (s.flame_count > 0) & (
            q.get(s.flames.timer, s.flame_head, 0) == 0)

    return masked_loop(lambda s: pop_flame(s, front_done(s)), state,
                       front_done, MAX_FLAMES + 1)


def tick_bombs(state: State) -> State:
    """util::TickBombs (step_utility.cpp:224-245).

    All bomb timers decrement; then bombs explode from the queue front while
    the front timer is 0 (a non-zero front stops the sweep -- bombs behind it
    do NOT explode this step even at 0), at most the snapshot count.  The
    sweep and the traversals run as one loop (module docstring).
    """
    valid = _valid_slots(state.bomb_head, state.bomb_count, MAX_BOMBS)
    timer = torch.where(valid, state.bombs.timer - 1, state.bombs.timer)
    state = state._replace(bombs=state.bombs._replace(timer=timer))
    snapshot = state.bomb_count
    b, dev = snapshot.shape[0], snapshot.device

    def start_of(state, stk, i):
        return ((stk.sp == 0) & (i < snapshot) & (state.bomb_count > 0)
                & (q.get(state.bombs.timer, state.bomb_head, 0) == 0))

    # The sweep and the traversals as one loop; one host read an iteration
    # says which of the two arms any board takes.
    stk = _new_stack(b, dev)
    i = torch.zeros(b, dtype=I32, device=dev)
    for _ in range(MAX_BOMBS * (_DFS_CAP + 1)):
        start = start_of(state, stk, i)
        any_dfs, any_start = any_flags(stk.sp > 0, start)
        if not (any_dfs or any_start):
            break
        if any_dfs:
            state, stk = _dfs_step((state, stk))
        if any_start:
            state, stk = _start_top_bomb(state, stk, start)
            i = i + start.to(I32)
    return state

"""Phase 2: bomb kinematics -- blocking, kicking, collisions, bounce-back,
batched.

Counterpart of ``pomcpp_tpu.engine.bombs`` (reference step.cpp:188-278 and
step_utility.cpp:62-128, 279-329).  The reference's tail recursion
AgentBombChainReversion runs as a bounded masked loop over the chain, one
link per iteration, at most ``_MAX_CHAIN`` links.

Sequencing quirks preserved:
* Both passes iterate in queue order; the *move* pass re-reads
  ``bomb_count`` every iteration because mid-loop explosions (a bomb kicked
  into flames) shrink the queue under the loop (step.cpp:230).
* The bomb destination arrays fed to reversion are filled once, before the
  block pass, and never refreshed (step.cpp:191-192).
* Bomb identity in collision checks is value equality of all fields.

Cells computed from a bomb's stored position go through ``read_clamped``
/ ``write_dropping`` (JAX's out-of-range semantics, ``core.state``): a
bounce-back that meets a misaligned logical index can store an off-board
position.

Every board starts both passes at logical index 0 and advances one index
an iteration, so the index is the iteration number, a Python int.  Counts
never grow during phase 2, so the host reads the largest ``bomb_count``
once and both passes run that many iterations; a board past its own count
is a no-op, as in JAX.  The arms that are rare (a collision to resolve, a
bomb kicked into a flame, a bounce-back chain) run only when some board
takes them: one host read each.
"""

from __future__ import annotations

import torch

from ..core import queue as q
from ..core.constants import (
    AGENT_COUNT,
    C_AGENT0,
    C_BOMB,
    C_FLAME,
    C_PASSAGE,
    M_BOMB,
    M_IDLE,
    MAX_BOMBS,
)
from ..core.state import (
    Bombs,
    I32,
    State,
    _logical_index,
    bomb_at,
    cell_index,
    get_agent,
    get_bomb_index,
    has_bomb,
    index_col,
    is_agent,
    is_out_of_bounds,
    is_static_mov_block,
    is_walkable,
    read_at,
    read_clamped,
    write_at,
    write_dropping,
)
from .flames import any_active, any_flags, explode_bomb_at, masked_loop
from . import util

_MAX_CHAIN = AGENT_COUNT + MAX_BOMBS + 1


def chain_reversion(state: State, moves, bdest_x, bdest_y, agent_id,
                    active=None) -> State:
    """util::AgentBombChainReversion (step_utility.cpp:62-128), iteratively,
    on the boards of ``active`` (all when None).

    Bounces ``agent_id`` back to its origin cell, cascading through any
    agent that took that cell and any kicked bomb destined for it.
    """
    b, dev = state.board.shape[0], state.board.device
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=dev)
    cur = torch.as_tensor(agent_id, device=dev).to(I32).expand(b)
    li = torch.arange(MAX_BOMBS, device=dev)

    def body(carry):
        state, cur_val, active, n = carry
        cur = index_col(cur_val)
        m = read_at(moves, cur)
        ax, ay = read_at(state.agent_x, cur), read_at(state.agent_y, cur)
        ox, oy = util.origin_position(ax, ay, m)
        oob = is_out_of_bounds(ox, oy)
        oxc, oyc = ox.clamp(0, 10), oy.clamp(0, 10)
        # An out-of-bounds origin makes the whole link a no-op (124-127).
        link = active & ~oob

        # Who/what is at the origin BEFORE we move back (70-82).
        ia = get_agent(state, oxc, oyc)
        bmatch = ((li < state.bomb_count[:, None]) & (bdest_x == ox[:, None])
                  & (bdest_y == oy[:, None]))
        has_bomb_dest = bmatch.any(1)
        bidx = bmatch.to(I32).argmax(1)

        # Move the agent back (84-87).
        oc = cell_index(oxc, oyc)
        state = state._replace(
            agent_x=write_at(state.agent_x, cur, ox, link),
            agent_y=write_at(state.agent_y, cur, oy, link),
            board=write_at(state.board, oc, C_AGENT0 + cur_val, link),
        )

        # No agent at the origin: maybe revert a kicked bomb (89-121).
        after = link & (ia == -1)
        bb = bomb_at(state, bidx)
        bdx, bdy = read_at(bdest_x, bidx), read_at(bdest_y, bidx)
        obx, oby = util.origin_position(bdx, bdy, bb.dir.clamp(0, 4))
        self_laid = has_bomb_dest & (obx == bdx) & (oby == bdy)
        obc = cell_index(obx.clamp(0, 10), oby.clamp(0, 10))
        ha = get_agent(state, obx, oby)
        # Bounced back onto a bomb it just laid (101-106), else stop the
        # bomb and put it back (108-111).
        put_back = after & has_bomb_dest & ~self_laid
        h = state.bomb_head
        state = state._replace(
            board=write_at(state.board, obc,
                           torch.where(self_laid, C_AGENT0 + cur_val, C_BOMB),
                           after & has_bomb_dest),
            bombs=state.bombs._replace(
                dir=q.set_(state.bombs.dir, h, bidx, 0, put_back),
                x=q.set_(state.bombs.x, h, bidx, obx, put_back),
                y=q.set_(state.bombs.y, h, bidx, oby, put_back),
            ),
        )
        chase = link & (ia != -1)
        cont = chase | (put_back & (ha != -1))
        nxt = torch.where(chase, ia, torch.where(cont, ha, 0))
        return (state, torch.where(active, nxt, cur_val).to(I32), active & cont,
                n + active.to(I32))

    state, _, _, _ = masked_loop(
        body, (state, cur, active, torch.zeros(b, dtype=I32, device=dev)),
        lambda c: c[2] & (c[3] < _MAX_CHAIN), _MAX_CHAIN)
    return state


def _position_dir(state: State, i):
    """x, y and dir of logical bomb ``i`` (what the passes read of it)."""
    x, y, d = q.get_many((state.bombs.x, state.bombs.y, state.bombs.dir),
                         state.bomb_head, i)
    return Bombs(x, y, None, None, None, d, None)


def _collidees(state: State, i):
    """PHYSICAL slots ``[B, 20]`` of the bombs in the logical window
    [i, count) whose value (all seven fields) differs from bomb i's and
    whose destination is bomb i's (step_utility.cpp:279-312).  Bomb
    identity is the value of the packed bomb int, so comparing every field
    is the reference's test."""
    b = state.bombs
    fields = torch.stack([b.x, b.y, b.id, b.strength, b.timer, b.dir,
                          b.moved.to(I32)], 2)
    s = ((state.bomb_head + i) % MAX_BOMBS).long()
    bi = fields.gather(1, s[:, None, None].expand(-1, 1, fields.shape[2]))
    same = (fields == bi).all(2)
    tx, ty = util.desired_position(bi[:, 0, 0], bi[:, 0, 1],
                                   bi[:, 0, 5].clamp(0, 4))
    dx, dy = util.desired_position(b.x, b.y, b.dir.clamp(0, 4))
    r = _logical_index(state.bomb_head, MAX_BOMBS)
    return ((r >= i) & (r < state.bomb_count[:, None]) & ~same
            & (dx == tx[:, None]) & (dy == ty[:, None]))


def has_bomb_collision(state: State, i):
    """util::HasBombCollision (step_utility.cpp:279-293), window [i, count)."""
    return _collidees(state, i).any(1)


def resolve_bomb_collision(state: State, moves, bdest_x, bdest_y, i,
                           mask=None) -> State:
    """util::ResolveBombCollision (step_utility.cpp:295-329) on the boards
    of ``mask`` (all when None)."""
    bi = bomb_at(state, i)
    collidees = _collidees(state, i)
    if mask is not None:
        collidees = collidees & mask[:, None]
    has_collided = collidees.any(1)

    # All collidees go idle (305-312).
    h = state.bomb_head
    new_dir = torch.where(collidees, 0, state.bombs.dir)
    state = state._replace(bombs=state.bombs._replace(dir=new_dir))

    # If this bomb was moving, stop it and bounce back its kicker (313-327).
    was_moving = has_collided & (bi.dir != 0)
    state = state._replace(bombs=state.bombs._replace(
        dir=q.set_(state.bombs.dir, h, i, 0, was_moving)))
    ia = get_agent(state, bi.x, bi.y)
    mv = read_at(moves, ia.clamp(0, 3))
    revert = was_moving & (ia > -1) & (mv != M_IDLE) & (mv != M_BOMB)
    if not any_active(revert):
        return state
    state = chain_reversion(state, moves, bdest_x, bdest_y,
                            torch.where(revert, ia, 0), revert)
    # The reference writes through a live reference to bombs[i], whose
    # position the reversion may have just changed (step_utility.cpp:322-323).
    after = bomb_at(state, i)
    return state._replace(board=write_dropping(
        state.board, cell_index(after.x, after.y), C_BOMB, revert))


def bomb_block_pass(state: State, moves, bdest_x, bdest_y, old_x, old_y,
                    n: int | None = None) -> State:
    """step.cpp:195-227: stop bombs blocked by walls/static items/agents and
    bounce back any agent that moved onto a now-stuck bomb this turn.
    ``n`` is the largest ``bomb_count`` of the batch (read when None)."""
    if n is None:
        n = int(state.bomb_count.max())
    for i in range(n):
        in_range = i < state.bomb_count
        b = _position_dir(state, i)
        tx, ty = util.desired_position(b.x, b.y, b.dir.clamp(0, 4))
        titem = read_at(state.board,
                        cell_index(tx.clamp(0, 10), ty.clamp(0, 10)))
        blocked = in_range & (is_out_of_bounds(tx, ty)
                              | is_static_mov_block(titem) | is_agent(titem))
        state = state._replace(bombs=state.bombs._replace(
            dir=q.set_(state.bombs.dir, state.bomb_head, i, 0, blocked)))

        ia = get_agent(state, b.x, b.y)
        sa = ia.clamp(0, 3)
        mv = read_at(moves, sa)
        # Bounced back to the bomb he was already standing on (212-214).
        stayed = ((read_at(state.agent_x, sa) == read_at(old_x, sa))
                  & (read_at(state.agent_y, sa) == read_at(old_y, sa)))
        revert = (blocked & (ia > -1) & (mv != M_IDLE) & (mv != M_BOMB)
                  & ~stayed)
        if not any_active(revert):
            continue
        state = chain_reversion(state, moves, bdest_x, bdest_y,
                                torch.where(revert, ia, 0), revert)
        # Restore the BOMB item if the reversion vacated this bomb's cell.
        vacated = get_agent(state, b.x, b.y) == -1
        state = state._replace(board=write_dropping(
            state.board, cell_index(b.x, b.y), C_BOMB, revert & vacated))
    return state


def bomb_move_pass(state: State, moves, bdest_x, bdest_y,
                   n: int | None = None) -> State:
    """step.cpp:230-278: move kicked bombs, resolve bomb-bomb collisions,
    explode bombs sliding into flames.  ``n`` bounds the iterations (the
    largest ``bomb_count`` before the pass; read when None)."""
    if n is None:
        n = int(state.bomb_count.max())
    for i in range(n):
        active = i < state.bomb_count
        b = _position_dir(state, i)
        collides = has_bomb_collision(state, i)

        # Idle bombs: only collision resolution (step.cpp:234-241).
        idle_resolve = (b.dir == 0) & collides
        tx, ty = util.desired_position(b.x, b.y, b.dir.clamp(0, 4))
        tc = cell_index(tx.clamp(0, 10), ty.clamp(0, 10))
        titem = read_at(state.board, tc)
        can_enter = ~is_out_of_bounds(tx, ty) & ~is_static_mov_block(titem)
        do_resolve = active & (idle_resolve | (can_enter & collides))

        advance = active & ~do_resolve
        do_move = advance & can_enter
        go_idle = advance & ~can_enter
        walk = is_walkable(titem)
        into_flame = do_move & ~walk & (titem == C_FLAME)
        # An idle bomb that "moves" onto its own cell writes what is there
        # already: the advance writes matter only where a bomb slides, goes
        # idle, or its target is walkable or burning.  One host read says
        # which arms any board takes (resolve and advance touch disjoint
        # boards, so all three are read before either runs).
        writes = go_idle | (do_move & ((b.dir != 0) | walk
                                       | (titem == C_FLAME)))
        any_resolve, any_write, any_flame = any_flags(do_resolve, writes,
                                                      into_flame)
        if any_resolve:
            state = resolve_bomb_collision(state, moves, bdest_x, bdest_y, i,
                                           do_resolve)
        if not any_write:
            continue
        h = state.bomb_head
        bombs = state.bombs._replace(
            x=q.set_(state.bombs.x, h, i, tx, do_move),
            y=q.set_(state.bombs.y, h, i, ty, do_move),
            dir=q.set_(state.bombs.dir, h, i, 0, go_idle),
        )
        state = state._replace(bombs=bombs)
        # Clear the old cell if no bomb remains there (step.cpp:260-263).
        oc = cell_index(b.x, b.y)
        clear = (do_move & ~has_bomb(state, b.x, b.y)
                 & (read_clamped(state.board, oc) == C_BOMB))
        board = write_dropping(state.board, oc, C_PASSAGE, clear)
        state = state._replace(board=write_at(board, tc, C_BOMB,
                                              do_move & walk))
        if any_flame:
            state = explode_bomb_at(state, get_bomb_index(state, tx, ty),
                                    into_flame)
    return state

"""The cellular step engine as batched PyTorch plane ops.

Counterpart of ``pomcpp_tpu.engine.cellular``: the game re-derived as a
cellular automaton over per-cell planes.  Every function here takes a batch:
cell planes are ``[B, 121]`` int32 (flat index ``x + 11*y``), agent arrays
``[B, 4]``, and ``alive_count`` / ``timestep`` are ``[B]``.  This module is
the plain version every kernel of the port is held against, and it is held
itself, field for field, against ``jax.vmap(cellular_step)``.

The documented divergences from the C++ reference are kept as they are in
the JAX engine (each is an explicit rule choice):

1. Planting on a cell that already holds a bomb is refused.
2. A fresh plant always starts with direction IDLE.
3. Explosion chains run in breadth-first rounds on the round-start board
   instead of depth-first with suspend/resume.
4. Simultaneous multi-chain bounce-backs and multi-bomb pileups resolve in
   cell order rather than queue order.

``cellular_step(..., max_chain_rounds=4)`` is the semantics of the fused
kernels: deeper same-step chains leave their remaining bombs for later
steps (see ``engine.fused_step``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    BOMB_LIFETIME,
    C_AGENT0,
    C_BOMB,
    C_EXTRABOMB,
    C_FLAME,
    C_INCRRANGE,
    C_KICK,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    FLAME_LIFETIME,
    M_BOMB,
    MOVE_DX,
    MOVE_DY,
    NUM_CELLS,
)
from ..core.state import I32, flag_item, is_agent, is_powerup
from ..device import resolve_device

_NEG = -1000
# Direction codes reuse move codes 1..4: UP(-y), DOWN(+y), LEFT(-x), RIGHT(+x).
_OPP = {1: 2, 2: 1, 3: 4, 4: 3}


class CellState(NamedTuple):
    """Plane-encoded game state with a leading batch axis."""

    board: torch.Tensor          # i32[B, 121] cell classes (C_*)
    hidden_pow: torch.Tensor     # i32[B, 121] hidden powerup under WOOD / FLAME
    flame_timer: torch.Tensor    # i32[B, 121] steps until flame clears
    bomb_timer: torch.Tensor     # i32[B, 121] ticks to explosion (0 = no bomb)
    bomb_strength: torch.Tensor  # i32[B, 121] blast radius (stored at plant)
    bomb_dir: torch.Tensor       # i32[B, 121] sliding direction (0 = idle)
    bomb_owner: torch.Tensor     # i32[B, 121] owner agent id

    agent_x: torch.Tensor        # i32[B, 4]
    agent_y: torch.Tensor        # i32[B, 4]
    agent_bomb_count: torch.Tensor
    agent_max_bombs: torch.Tensor
    agent_strength: torch.Tensor
    agent_can_kick: torch.Tensor  # bool[B, 4]
    agent_dead: torch.Tensor      # bool[B, 4]

    alive_count: torch.Tensor    # i32[B]
    timestep: torch.Tensor       # i32[B]


PLANE_FIELDS = CellState._fields[:7]
AGENT_FIELDS = CellState._fields[7:14]


def empty_cell_state(b: int, device=None) -> CellState:
    """All-passage boards, agents at (0,0), default stats, on ``device``
    (None: the card; ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
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


# --- Shift / one-hot primitives ------------------------------------------------


def _push(plane, d: int, fill):
    """What arrives at each cell from a move in direction d: out[c] = plane[c-d]."""
    p = plane.reshape(plane.shape[:-1] + (BOARD_SIZE, BOARD_SIZE))
    out = torch.full_like(p, fill)
    if d == 1:    # UP (y-1): arrives from below
        out[..., :-1, :] = p[..., 1:, :]
    elif d == 2:  # DOWN (y+1): arrives from above
        out[..., 1:, :] = p[..., :-1, :]
    elif d == 3:  # LEFT (x-1): arrives from the right
        out[..., :, :-1] = p[..., :, 1:]
    else:         # RIGHT (x+1): arrives from the left
        out[..., :, 1:] = p[..., :, :-1]
    return out.reshape(plane.shape)


def _pull(plane, d: int, fill):
    """Value at each cell's direction-d neighbor: out[c] = plane[c+d]."""
    return _push(plane, _OPP[d], fill)


def _dest_val(plane, dir_plane, fill):
    """Value at each cell's destination (dir 0 = the cell itself)."""
    out = plane
    for d in (1, 2, 3, 4):
        out = torch.where(dir_plane == d, _pull(plane, d, fill), out)
    return out


def _dest_oob(dir_plane):
    """True where the destination lies off-board."""
    cells = torch.arange(NUM_CELLS, device=dir_plane.device)
    x = cells % BOARD_SIZE
    y = cells // BOARD_SIZE
    return (
        ((dir_plane == 1) & (y == 0))
        | ((dir_plane == 2) & (y == BOARD_SIZE - 1))
        | ((dir_plane == 3) & (x == 0))
        | ((dir_plane == 4) & (x == BOARD_SIZE - 1))
    )


def _onehot(x, y):
    """[B, 4, 121] one-hot of agent cells (rows masked later by callers)."""
    cells = torch.arange(NUM_CELLS, device=x.device)
    return (x + BOARD_SIZE * y)[..., None] == cells


def _read_cells(plane, oh):
    """plane[cell_i] for each agent via one-hot reduce -> [B, 4]."""
    if plane.dtype == torch.bool:
        return (oh & plane[:, None, :]).any(-1)
    return torch.where(oh, plane[:, None, :], 0).sum(-1, dtype=I32)


def _write_cells(plane, oh, values, mask):
    """Sequential per-agent cell writes (later agent wins)."""
    out = plane
    for i in range(AGENT_COUNT):
        sel = oh[:, i] & mask[:, i : i + 1]
        out = torch.where(sel, values[:, i : i + 1], out)
    return out


def _move_table(m, table):
    return torch.tensor(table, dtype=I32, device=m.device)[m.long()]


# --- Phase 0: flame decay ------------------------------------------------------


def _tick_flames(cs: CellState) -> CellState:
    ft = (cs.flame_timer - 1).clamp(min=0)
    expired = (ft == 0) & (cs.board == C_FLAME)
    return cs._replace(
        board=torch.where(expired, flag_item(cs.hidden_pow & 0b11), cs.board),
        hidden_pow=torch.where(expired, 0, cs.hidden_pow),
        flame_timer=ft,
    )


# --- Phase 1: agent movement ---------------------------------------------------


def _fix_switch(ax, ay, dx, dy):
    """FixSwitchMove (step_utility.cpp:154-170), same pair order."""
    dx, dy = dx.clone(), dy.clone()
    for i in range(AGENT_COUNT):
        for j in range(i, AGENT_COUNT):
            swap = (
                (dx[:, i] == ax[:, j]) & (dy[:, i] == ay[:, j])
                & (dx[:, j] == ax[:, i]) & (dy[:, j] == ay[:, i])
            )
            dx[:, i] = torch.where(swap, ax[:, i], dx[:, i])
            dy[:, i] = torch.where(swap, ay[:, i], dy[:, i])
            dx[:, j] = torch.where(swap, ax[:, j], dx[:, j])
            dy[:, j] = torch.where(swap, ay[:, j], dy[:, j])
    return dx, dy


def _move_agents(cs: CellState, moves):
    dev = moves.device
    alive = ~cs.agent_dead
    m = moves.clamp(0, 5)
    directional = (m >= 1) & (m <= 4)
    ax, ay = cs.agent_x, cs.agent_y
    dx = ax + _move_table(m, MOVE_DX)
    dy = ay + _move_table(m, MOVE_DY)
    dx, dy = _fix_switch(ax, ay, dx, dy)
    directional = directional & ((dx != ax) | (dy != ay))

    inb = (dx >= 0) & (dy >= 0) & (dx < BOARD_SIZE) & (dy < BOARD_SIZE)
    oh_dest = _onehot(dx.clamp(0, 10), dy.clamp(0, 10)) & inb[..., None]
    oh_org = _onehot(ax, ay)
    dest_item = _read_cells(cs.board, oh_dest)

    # Ouroboros: nobody is a movement root (step_utility.cpp:172-205).
    ids = torch.arange(AGENT_COUNT, device=dev)
    other = ids[:, None] != ids[None, :]
    targets_other = (
        alive[:, None, :] & other
        & (dx[:, :, None] == ax[:, None, :]) & (dy[:, :, None] == ay[:, None, :])
    )
    is_root = cs.agent_dead | ~targets_other.any(2)
    ouroboros = ~is_root.any(1, keepdim=True)

    # Flame deaths (step.cpp:84-99).
    victim = alive & directional & inb & (dest_item == C_FLAME)

    # Destination collisions among live non-victims (step_utility.cpp:264-277).
    cand = alive & ~victim
    same_dest = (
        cand[:, None, :] & other
        & (dx[:, :, None] == dx[:, None, :]) & (dy[:, :, None] == dy[:, None, :])
    )
    coll = same_dest.any(2)

    base = alive & directional & inb & ~victim & ~coll
    enterable = (
        (dest_item == C_PASSAGE) | is_powerup(dest_item) | (dest_item == C_BOMB)
    )
    dest_agent = is_agent(dest_item)
    dest_aid = (dest_item - C_AGENT0).clamp(0, 3).long()

    # Chain fixed point: entering an occupied cell requires its occupant to
    # vacate (move or die); a 4-cycle rotates unconditionally (step.cpp:70-82).
    move = torch.zeros_like(alive)
    for _ in range(AGENT_COUNT):
        vacating = dest_agent & (
            move.gather(1, dest_aid) | victim.gather(1, dest_aid)
        )
        move = base & (enterable | vacating | (ouroboros & dest_agent))

    # Kicks: mover onto a bomb cell with canKick (step.cpp:147-169).
    has_bomb_dest = _read_cells(cs.bomb_timer, oh_dest) > 0
    kick = move & cs.agent_can_kick & has_bomb_dest
    bomb_dir = _write_cells(cs.bomb_dir, oh_dest, m, kick)

    # Powerups (step.cpp:111-114, step_utility.cpp:247-262).
    take = move & is_powerup(dest_item)
    max_bombs = cs.agent_max_bombs + (take & (dest_item == C_EXTRABOMB)).to(I32)
    strength = cs.agent_strength + (take & (dest_item == C_INCRRANGE)).to(I32)
    can_kick = cs.agent_can_kick | (take & (dest_item == C_KICK))

    # Board: vacate origins of movers and flame victims, then place movers.
    vacate = move | victim
    org_bomb = _read_cells(cs.bomb_timer, oh_org) > 0
    vac_val = torch.where(org_bomb, C_BOMB, C_PASSAGE).to(I32)
    board = _write_cells(cs.board, oh_org, vac_val, vacate)
    agent_codes = (C_AGENT0 + ids).to(I32).expand_as(ax)
    board = _write_cells(board, oh_dest, agent_codes, move)

    dead = cs.agent_dead | victim
    alive_count = cs.alive_count - victim.sum(1, dtype=I32)
    nx = torch.where(move, dx, ax)
    ny = torch.where(move, dy, ay)

    # Plants: BOMB move, capacity left, no bomb already here (divergence #1).
    plant = (
        alive
        & (moves == M_BOMB)
        & (cs.agent_bomb_count < cs.agent_max_bombs)
        & ~org_bomb
    )
    lt = torch.full_like(ax, BOMB_LIFETIME + 1)
    bomb_timer = _write_cells(cs.bomb_timer, oh_org, lt, plant)
    bomb_strength = _write_cells(cs.bomb_strength, oh_org, cs.agent_strength,
                                 plant)
    bomb_owner = _write_cells(cs.bomb_owner, oh_org, ids.to(I32).expand_as(ax),
                              plant)
    bomb_dir = _write_cells(bomb_dir, oh_org, torch.zeros_like(ax), plant)

    return cs._replace(
        board=board,
        bomb_timer=bomb_timer,
        bomb_strength=bomb_strength,
        bomb_dir=bomb_dir,
        bomb_owner=bomb_owner,
        agent_x=nx,
        agent_y=ny,
        agent_bomb_count=cs.agent_bomb_count + plant.to(I32),
        agent_max_bombs=max_bombs,
        agent_strength=strength,
        agent_can_kick=can_kick,
        agent_dead=dead,
        alive_count=alive_count,
    )


# --- Phase 2: bomb kinematics --------------------------------------------------


def _static_block(item):
    return (item == C_RIGID) | (item == C_WOOD) | is_powerup(item)


def _revert_chain(cs: CellState, moves, trigger, dir0):
    """AgentBombChainReversion (step_utility.cpp:62-128), vectorized.

    ``trigger`` is a bool[B, 4] mask of agents to bounce back; chains
    cascade through displaced agents and kicked bombs destined for vacated
    cells.  ``dir0`` is the phase-start direction plane: the reference fills
    bomb destinations once and reversion sees those stale values
    (step.cpp:191-192).  The chain has at most AGENT_COUNT + 2 links; a link
    with no active agent anywhere in the batch changes nothing, so the loop
    stops there.
    """
    ids = torch.arange(AGENT_COUNT, device=moves.device)
    other = ids[:, None] != ids[None, :]
    m = moves.clamp(0, 5)
    mdx = _move_table(m, MOVE_DX)
    mdy = _move_table(m, MOVE_DY)
    has_bomb = cs.bomb_timer > 0
    alive = ~cs.agent_dead
    agent_codes = (C_AGENT0 + ids).to(I32).expand_as(mdx)

    board, ax, ay, bomb_dir = cs.board, cs.agent_x, cs.agent_y, cs.bomb_dir
    cur = trigger
    done = torch.zeros_like(trigger)
    for _ in range(AGENT_COUNT + 2):
        if not bool(cur.any()):
            break
        ox = ax - mdx
        oy = ay - mdy
        oinb = (ox >= 0) & (oy >= 0) & (ox < BOARD_SIZE) & (oy < BOARD_SIZE)
        act = cur & oinb
        done = done | act
        oh_org = _onehot(ox.clamp(0, 10), oy.clamp(0, 10)) & act[..., None]

        # Occupant of each origin cell (get_agent, bboard.cpp:289-299).
        here = (
            alive[:, None, :]
            & (ax[:, None, :] == ox[:, :, None])
            & (ay[:, None, :] == oy[:, :, None])
            & other
        )
        occ = torch.where(here.any(2), here.to(I32).argmax(2), -1)

        # Bomb handling runs only when no agent occupies the origin
        # (step_utility.cpp:70-121: the agent branch takes priority).
        no_occ = act & (occ < 0)
        wanted = (oh_org & no_occ[..., None]).any(1)
        # A bomb is "destined" for a wanted cell per its STALE direction.
        dest_wanted = _dest_val(wanted, dir0, False)
        moving_bomb = has_bomb & dest_wanted & (bomb_dir != 0)
        bomb_dir = torch.where(moving_bomb, 0, bomb_dir)
        board = torch.where(moving_bomb & ~is_agent(board), C_BOMB, board)

        # Move the reverting agents back.
        board = _write_cells(board, oh_org, agent_codes, act)
        ax = torch.where(act, ox, ax)
        ay = torch.where(act, oy, ay)

        # Next links: displaced occupants, plus agents standing where a
        # moving bomb was just stopped (step_utility.cpp:113-120).
        nxt = (
            (act & (occ >= 0))[:, :, None] & (occ[:, :, None] == ids)
        ).any(1)
        on_stopped = _read_cells(moving_bomb, _onehot(ax, ay)) & alive
        cur = (nxt | on_stopped) & ~done
    return cs._replace(board=board, agent_x=ax, agent_y=ay, bomb_dir=bomb_dir)


def _restore_bomb_items(cs: CellState) -> CellState:
    """Show C_BOMB on bomb cells no live agent stands on (post-reversion)."""
    occupied = (
        _onehot(cs.agent_x, cs.agent_y) & ~cs.agent_dead[..., None]
    ).any(1)
    show = (cs.bomb_timer > 0) & ~occupied & is_agent(cs.board)
    return cs._replace(board=torch.where(show, C_BOMB, cs.board))


def _bomb_phase(cs: CellState, moves, old_x, old_y):
    """Block pass + move pass (step.cpp:188-278).  Returns (cs, slide_explode)."""
    dir0 = cs.bomb_dir  # stale directions for reversion (step.cpp:191-192)
    directional_move = (moves >= 1) & (moves <= 4)

    # Block pass (step.cpp:195-227): two rounds, because a reversion can land
    # an agent on another bomb's target and block it too.  A bomb is blocked
    # when its target cell (own cell for idle bombs) is OOB, a static item,
    # or an agent.
    for _ in range(2):
        agent_moved = (cs.agent_x != old_x) | (cs.agent_y != old_y)
        dest_item = _dest_val(cs.board, cs.bomb_dir, C_RIGID)
        blocked = (cs.bomb_timer > 0) & (
            _dest_oob(cs.bomb_dir) | _static_block(dest_item)
            | is_agent(dest_item)
        )
        oh_pos = _onehot(cs.agent_x, cs.agent_y)
        trigger = (
            ~cs.agent_dead
            & _read_cells(blocked, oh_pos)
            & directional_move
            & agent_moved
        )
        cs = cs._replace(bomb_dir=torch.where(blocked, 0, cs.bomb_dir))
        cs = _revert_chain(cs, moves, trigger, dir0)
        cs = _restore_bomb_items(cs)

    # Move pass (step.cpp:230-278).
    has_bomb = cs.bomb_timer > 0
    moving = has_bomb & (cs.bomb_dir != 0)
    dest_item = _dest_val(cs.board, cs.bomb_dir, C_RIGID)
    can_enter = ~_dest_oob(cs.bomb_dir) & ~_static_block(dest_item)

    # Collisions: >= 2 bombs targeting one cell all stop (an idle bomb's
    # target is its own cell, step_utility.cpp:279-329).
    arrivals = (has_bomb & ~moving).to(I32)
    for d in (1, 2, 3, 4):
        arrivals = arrivals + _push((moving & (cs.bomb_dir == d)).to(I32), d, 0)
    dest_count = _dest_val(arrivals, torch.where(moving, cs.bomb_dir, 0), 0)
    collide = has_bomb & (dest_count >= 2)
    stopped_kick = collide & moving
    cs = cs._replace(
        bomb_dir=torch.where(collide | (moving & ~can_enter), 0, cs.bomb_dir)
    )

    # Kicker bounce-back for stopped kicked bombs (step_utility.cpp:313-327).
    oh_pos = _onehot(cs.agent_x, cs.agent_y)
    trigger = (
        ~cs.agent_dead & _read_cells(stopped_kick, oh_pos) & directional_move
    )
    cs = _revert_chain(cs, moves, trigger, dir0)
    cs = _restore_bomb_items(cs)

    # Surviving movers advance one cell (unique destinations by collision).
    do_move = (cs.bomb_timer > 0) & (cs.bomb_dir != 0) & can_enter & ~collide

    def advance(plane):
        stay = torch.where(do_move, 0, plane)
        inc = torch.zeros_like(plane)
        for d in (1, 2, 3, 4):
            inc = torch.maximum(
                inc,
                _push(torch.where(do_move & (cs.bomb_dir == d), plane, 0), d, 0),
            )
        return torch.maximum(stay, inc)

    arrived = torch.zeros_like(do_move)
    for d in (1, 2, 3, 4):
        arrived = arrived | _push(do_move & (cs.bomb_dir == d), d, False)

    moved = cs._replace(
        bomb_timer=advance(cs.bomb_timer),
        bomb_strength=advance(cs.bomb_strength),
        bomb_dir=advance(cs.bomb_dir),
        bomb_owner=advance(cs.bomb_owner),
    )

    # Board bookkeeping (step.cpp:255-272): vacated bomb cells revert to
    # passage, entered walkable cells show the bomb, and a bomb arriving on
    # a flame cell explodes (handled by phase 3 with live owner strength).
    vacated = do_move & (cs.board == C_BOMB) & (moved.bomb_timer == 0)
    board = torch.where(vacated, C_PASSAGE, cs.board)
    slide_explode = arrived & (board == C_FLAME)
    board = torch.where(
        arrived & ((board == C_PASSAGE) | is_powerup(board)), C_BOMB, board
    )
    return moved._replace(board=board), slide_explode


# --- Phase 3: explosions -------------------------------------------------------


def _ray_reach(board, origin_allowance):
    """Cells an explosion ray arrives at with allowance >= 0.

    A ray leaves each origin along the 4 axis directions and loses one unit
    of allowance per cell; it enters a cell if the allowance left is >= 0 and
    the cell is not rigid, and it goes on only through cells that are
    neither rigid nor wood.  Same set as the JAX engine's blocked max-plus
    scan (``arriving >= 0``).
    """
    rigid = board == C_RIGID
    absorb = rigid | (board == C_WOOD)
    reach = torch.zeros_like(rigid)
    rays = [origin_allowance] * 4
    for _ in range(BOARD_SIZE - 1):
        for k, d in enumerate((1, 2, 3, 4)):
            inc = _push(rays[k], d, _NEG) - 1
            entered = (inc >= 0) & ~rigid
            reach = reach | entered
            rays[k] = torch.where(entered & ~absorb, inc, _NEG)
        if not bool(torch.stack(rays).ge(1).any()):
            break
    return reach


def _explode(cs: CellState, slide_explode, max_rounds=None):
    """Tick timers, explode timer==0 and slid-into-flame bombs, chain in
    rounds, write flames (per-cell timers), kill agents, burn wood.

    ``max_rounds`` caps the chain rounds of one step (None: run the chain
    to its end)."""
    has_bomb = cs.bomb_timer > 0
    timer = torch.where(has_bomb, cs.bomb_timer - 1, 0)
    cs = cs._replace(bomb_timer=torch.where(slide_explode, cs.bomb_timer, timer))

    explode = ((cs.bomb_timer == 0) & has_bomb) | slide_explode
    live = slide_explode  # live-owner strength (ExplodeBombAt, bboard.cpp:111)
    rounds = 0
    while bool(explode.any()) and (max_rounds is None or rounds < max_rounds):
        rounds += 1
        # Stored strength for timer explosions (ExplodeTopBomb), the owner's
        # live strength for slide/chained ones.
        live_strength = cs.agent_strength.gather(1, cs.bomb_owner.long())
        s_cell = torch.where(live, live_strength, cs.bomb_strength)

        reach = _ray_reach(cs.board, torch.where(explode, s_cell, _NEG))
        burn = explode | (reach & (cs.board != C_RIGID))

        was_wood = burn & (cs.board == C_WOOD)
        kill_cell = burn & is_agent(cs.board)
        aid = cs.board - C_AGENT0
        victims = torch.stack(
            [(kill_cell & (aid == i)).any(1) for i in range(AGENT_COUNT)], 1
        )
        refund = torch.stack(
            [(explode & (cs.bomb_owner == i)).sum(1, dtype=I32)
             for i in range(AGENT_COUNT)], 1
        )
        newly_dead = victims & ~cs.agent_dead

        next_explode = burn & (cs.bomb_timer > 0) & ~explode

        cs = cs._replace(
            board=torch.where(burn, C_FLAME, cs.board),
            hidden_pow=torch.where(burn & ~was_wood, 0, cs.hidden_pow),
            flame_timer=torch.where(burn, FLAME_LIFETIME, cs.flame_timer),
            bomb_timer=torch.where(explode, 0, cs.bomb_timer),
            bomb_strength=torch.where(explode, 0, cs.bomb_strength),
            bomb_dir=torch.where(explode, 0, cs.bomb_dir),
            bomb_owner=torch.where(explode, 0, cs.bomb_owner),
            agent_bomb_count=cs.agent_bomb_count - refund,
            agent_dead=cs.agent_dead | victims,
            alive_count=cs.alive_count - newly_dead.sum(1, dtype=I32),
        )
        explode = live = next_explode
    return cs


# --- The step ------------------------------------------------------------------


def cellular_step(cs: CellState, moves, max_chain_rounds=None) -> CellState:
    """One simultaneous step over a batch of plane states.

    ``moves`` is i32[B, 4].  ``max_chain_rounds`` caps the explosion chain
    rounds per step (the fused kernels use 4); None resolves whole chains as
    the JAX ``cellular_step`` does.  ``timestep`` is left as it is.
    """
    moves = moves.to(I32)
    cs = _tick_flames(cs)
    old_x, old_y = cs.agent_x, cs.agent_y
    cs = _move_agents(cs, moves)
    cs, slide = _bomb_phase(cs, moves, old_x, old_y)
    return _explode(cs, slide, max_chain_rounds)


# --- Conversion from and to the queue-encoded State (host and test path) -------


def board_of(cs: CellState, i: int = 0) -> CellState:
    """Board ``i`` of a batch, without its batch axis (what ``to_state`` and
    the renderer take)."""
    return CellState(*(t[i] for t in cs))


def from_state(s) -> CellState:
    """Scatter queue-encoded ``State``s into planes, on ``s``'s device.

    A batch (leading axis B on every field) gives a ``CellState`` batch;
    one board without a batch axis gives one board without it.
    ``bomb_*`` planes take the maximum over the live records on each cell
    (with 0); a FLAME cell's timer is the most over the live flame records
    whose origin matches its ``flame_sig``."""
    from ..core.queue import logical_view
    from ..core.state import map_state

    if s.board.dim() == 1:
        return board_of(from_state(map_state(lambda t: t[None], s)))
    dev = s.board.device
    b = s.board.shape[0]
    li = torch.arange(s.bombs.x.shape[1], device=dev)
    bx = logical_view(s.bombs.x, s.bomb_head)
    by = logical_view(s.bombs.y, s.bomb_head)
    valid = li < s.bomb_count[:, None]
    c = (bx + BOARD_SIZE * by).clamp(0, NUM_CELLS - 1).long()
    zero = torch.zeros((b, NUM_CELLS), dtype=I32, device=dev)

    def scat(field):
        vals = torch.where(valid, logical_view(field, s.bomb_head), 0).to(I32)
        return zero.scatter_reduce(1, c, vals, "amax")

    fli = torch.arange(s.flames.x.shape[1], device=dev)
    fx = logical_view(s.flames.x, s.flame_head)
    fy = logical_view(s.flames.y, s.flame_head)
    ft = logical_view(s.flames.timer, s.flame_head)
    fvalid = fli < s.flame_count[:, None]
    match = fvalid[:, None, :] & ((fx + BOARD_SIZE * fy)[:, None, :]
                                  == s.flame_sig[:, :, None])
    flame_timer = torch.where(match, ft[:, None, :], 0).amax(2) \
        * (s.board == C_FLAME)
    return CellState(
        board=s.board, hidden_pow=s.hidden_pow,
        flame_timer=flame_timer.to(I32),
        bomb_timer=scat(s.bombs.timer), bomb_strength=scat(s.bombs.strength),
        bomb_dir=scat(s.bombs.dir), bomb_owner=scat(s.bombs.id),
        agent_x=s.agent_x, agent_y=s.agent_y,
        agent_bomb_count=s.agent_bomb_count,
        agent_max_bombs=s.agent_max_bombs, agent_strength=s.agent_strength,
        agent_can_kick=s.agent_can_kick, agent_dead=s.agent_dead,
        alive_count=s.alive_count, timestep=s.timestep,
    )


def to_state(cs: CellState):
    """Rebuild a queue-encoded ``State`` from the planes of one board (no
    batch axis; ``board_of``), on ``cs``'s device.

    Bomb queue order is (timer asc, owner asc, cell asc): timers are
    monotone along the reference queue and same-step plants append in agent
    order.  Flame records are one per FLAME cell, its origin the cell
    itself, in (timer asc, cell asc) order, with ``flame_sig`` of the cell
    set to its own index.  Both queues start at head 0."""
    import numpy as np

    from ..core.state import empty_state

    dev = cs.board.device

    def host(t):
        return t.detach().cpu().numpy()

    board, bt, owner = host(cs.board), host(cs.bomb_timer), host(cs.bomb_owner)
    order = sorted(np.nonzero(bt > 0)[0].tolist(),
                   key=lambda c: (int(bt[c]), int(owner[c])))
    ft = host(cs.flame_timer)
    forder = sorted(np.nonzero((ft > 0) & (board == C_FLAME))[0].tolist(),
                    key=lambda c: int(ft[c]))
    s = empty_state(None, dev)
    bombs = {k: host(v) for k, v in s.bombs._asdict().items()}
    for i, c in enumerate(order):
        bombs["x"][i], bombs["y"][i] = c % BOARD_SIZE, c // BOARD_SIZE
        bombs["id"][i] = owner[c]
        bombs["strength"][i] = host(cs.bomb_strength)[c]
        bombs["timer"][i] = bt[c]
        bombs["dir"][i] = host(cs.bomb_dir)[c]
    flames = {k: host(v) for k, v in s.flames._asdict().items()}
    sig = host(s.flame_sig)
    for i, c in enumerate(forder):
        flames["x"][i], flames["y"][i] = c % BOARD_SIZE, c // BOARD_SIZE
        flames["timer"][i] = ft[c]
        sig[c] = c

    def dev_of(a):
        return torch.from_numpy(a).to(dev)

    return s._replace(
        board=cs.board.to(I32), hidden_pow=cs.hidden_pow.to(I32),
        flame_sig=dev_of(sig),
        agent_x=cs.agent_x, agent_y=cs.agent_y,
        agent_bomb_count=cs.agent_bomb_count,
        agent_max_bombs=cs.agent_max_bombs, agent_strength=cs.agent_strength,
        agent_can_kick=cs.agent_can_kick, agent_dead=cs.agent_dead,
        alive_count=cs.alive_count, timestep=cs.timestep,
        bombs=type(s.bombs)(**{k: dev_of(v) for k, v in bombs.items()}),
        bomb_count=torch.tensor(len(order), dtype=I32, device=dev),
        flames=type(s.flames)(**{k: dev_of(v) for k, v in flames.items()}),
        flame_count=torch.tensor(len(forder), dtype=I32, device=dev),
    )

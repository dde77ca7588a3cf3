"""The game's rules in plain PyTorch: the plane engine the benchmark holds
the port's kernels against.

Frozen copy, not an import: it was copied from the port at commit
d0a03242271a (``pomcpp_tpu_torch/core/constants.py`` whole,
``core/state.py`` ``cell_index`` .. ``put_agents_in_corners``,
``engine/util.py`` ``desired_position``, ``engine/cellular.py`` without its
conversions to the queue-encoded state), and imports nothing of the port,
of the JAX package or of JAX.  One change: ``cellular_step`` and
``_move_agents`` take ``move_rounds``, the rounds of the movement chain's
fixed point (4 by the rules; ``reference.control`` runs 1, which breaks
the rules' guarantee that a follower enters the cell its leader leaves).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32


BOARD_SIZE = 11
NUM_CELLS = BOARD_SIZE * BOARD_SIZE  # 121; flat index = x + BOARD_SIZE * y
AGENT_COUNT = 4
MOVE_COUNT = 4  # directional moves (reference bboard.hpp:15)
BOMB_LIFETIME = 10
BOMB_DEFAULT_STRENGTH = 1
FLAME_LIFETIME = 4
MAX_BOMBS_PER_AGENT = 5
MAX_BOMBS = AGENT_COUNT * MAX_BOMBS_PER_AGENT  # 20 queue slots
MAX_FLAMES = MAX_BOMBS  # reference uses the same capacity (bboard.hpp:385)
# --- Moves (reference bboard.hpp:35-52; Move and Direction share values 0..4) ---
M_IDLE = 0
M_UP = 1     # y - 1
M_DOWN = 2   # y + 1
M_LEFT = 3   # x - 1
M_RIGHT = 4  # x + 1
M_BOMB = 5
NUM_MOVES = 6
# Displacement tables indexed by move/direction code.
MOVE_DX = (0, 0, 0, -1, 1, 0)
MOVE_DY = (0, -1, 1, 0, 0, 0)
# --- Cell classes (our plane encoding; reference Item enum bboard.hpp:54-71) ---
C_PASSAGE = 0
C_RIGID = 1
C_WOOD = 2
C_BOMB = 3
C_FLAME = 4
C_FOG = 5        # reserved (reference declares FOG but never places it)
C_EXTRABOMB = 6
C_INCRRANGE = 7
C_KICK = 8
C_AGENT0 = 10    # agents are C_AGENT0 + id (id in [0, 4))


def cell_index(x, y):
    """Flat board index of (x, y)."""
    return x + BOARD_SIZE * y


def index_col(i) -> torch.Tensor:
    """A ``[B]`` index as the long ``[B, 1]`` column that ``read_at`` and
    ``write_at`` gather and scatter with (made once where an index serves
    several reads and writes)."""
    return i if i.dim() == 2 else i.long()[:, None]


def read_at(arr, i):
    """``arr[b, i[b]]`` for ``arr`` ``[B, N]``; ``i`` is an int, a ``[B]``
    tensor whose values lie in [0, N), or its ``index_col``."""
    if isinstance(i, int):
        return arr[:, i]
    return arr.gather(1, index_col(i))[:, 0]


def is_powerup(c):
    return (c >= C_EXTRABOMB) & (c <= C_KICK)


def is_agent(c):
    return c >= C_AGENT0


def is_walkable(c):
    return is_powerup(c) | (c == C_PASSAGE)


def flag_item(pwp):
    """Powerup flag -> cell class (reference State::FlagItem, bboard.cpp:182)."""
    out = torch.full_like(pwp, C_PASSAGE)
    out = torch.where(pwp == 1, C_EXTRABOMB, out)
    out = torch.where(pwp == 2, C_INCRRANGE, out)
    return torch.where(pwp == 3, C_KICK, out)


def put_agents_in_corners(cs, a0=0, a1=1, a2=2, a3=3):
    """Reference State::PutAgentsInCorners (bboard.cpp:322-333), batched.

    ``cs`` is any NamedTuple with ``board`` [B, 121] and ``agent_x`` /
    ``agent_y`` [B, 4].  Like the reference, only a1.x, a2.x, a2.y and a3.y
    are assigned; the other coordinates keep their (zero) values.
    """
    last = BOARD_SIZE - 1
    board = cs.board.clone()
    board[:, cell_index(0, 0)] = C_AGENT0 + a0
    board[:, cell_index(last, 0)] = C_AGENT0 + a1
    board[:, cell_index(last, last)] = C_AGENT0 + a2
    board[:, cell_index(0, last)] = C_AGENT0 + a3
    ax = cs.agent_x.clone()
    ay = cs.agent_y.clone()
    ax[:, a1] = last
    ax[:, a2] = last
    ay[:, a2] = last
    ay[:, a3] = last
    return cs._replace(board=board, agent_x=ax, agent_y=ay)


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=I32, device=like.device)


def desired_position(x, y, move):
    """util::DesiredPosition (step_utility.cpp:9-31); IDLE/BOMB stay put.

    ``move`` holds move codes in [0, 6); ``x``, ``y`` and ``move``
    broadcast against each other.
    """
    move = torch.as_tensor(move)
    idx = move.long().clamp(0, len(MOVE_DX) - 1)
    return x + _table(MOVE_DX, move)[idx], y + _table(MOVE_DY, move)[idx]


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


def _tick_flames(cs: CellState) -> CellState:
    ft = (cs.flame_timer - 1).clamp(min=0)
    expired = (ft == 0) & (cs.board == C_FLAME)
    return cs._replace(
        board=torch.where(expired, flag_item(cs.hidden_pow & 0b11), cs.board),
        hidden_pow=torch.where(expired, 0, cs.hidden_pow),
        flame_timer=ft,
    )


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


def _move_agents(cs: CellState, moves, move_rounds: int = AGENT_COUNT):
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
    for _ in range(move_rounds):
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


def cellular_step(cs: CellState, moves, max_chain_rounds=None,
                  move_rounds: int = AGENT_COUNT) -> CellState:
    """One simultaneous step over a batch of plane states.

    ``moves`` is i32[B, 4].  ``max_chain_rounds`` caps the explosion chain
    rounds per step (the fused kernels use 4); None resolves whole chains as
    the JAX ``cellular_step`` does.  ``timestep`` is left as it is.
    """
    moves = moves.to(I32)
    cs = _tick_flames(cs)
    old_x, old_y = cs.agent_x, cs.agent_y
    cs = _move_agents(cs, moves, move_rounds)
    cs, slide = _bomb_phase(cs, moves, old_x, old_y)
    return _explode(cs, slide, max_chain_rounds)


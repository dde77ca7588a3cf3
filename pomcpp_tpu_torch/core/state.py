"""Cell-class predicates, agent placement and the queue-encoded ``State``.

Counterpart of ``pomcpp_tpu.core.state``.  ``Bombs``, ``Flames`` and
``State`` are the JAX package's queue-encoded state with the same fields in
the same order: bomb and flame records live in fixed-size field arrays
whose logical element ``i`` is physical slot ``(head + i) % N``
(``core.queue``).  It is the state the exact conformance engine
(``engine.step``) steps.

Every function here works on a batch: a leading axis B on every field
(planes ``[B, 121]``, agents ``[B, 4]``, queue fields ``[B, 20]``, the
scalars ``[B]``).  Per-board indices (an agent id, a cell, a logical queue
index) are ``[B]`` tensors or Python ints.  The functions that write take
an optional ``mask`` (bool ``[B]``): boards where it is False are left bit
for bit as they were -- the port's form of a per-board ``lax.cond`` arm.
``to_state``, the renderer and ``empty_state(None)`` keep the one-board
form (no batch axis); ``state_of(s, i)`` takes board ``i`` of a batch.

Out-of-range indices: JAX clamps an out-of-range gather and drops an
out-of-range ``.at[].set``; PyTorch raises on the CPU and asserts on the
card.  ``read_at`` / ``write_at`` take indices that are in range by
construction (agent ids, clamped cells, argmax results, queue slots taken
mod N); an index that may leave its range -- a cell computed from a bomb's
stored position, which a misaligned bounce-back can put off the board --
goes through ``read_clamped`` (JAX's clamp) and ``write_dropping`` (JAX's
wrap-or-drop).

The plane-engine helpers (``is_powerup``, ``is_agent``, ``is_walkable``,
``flag_item``, ``put_agents_in_corners``) take any batched state.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from . import queue as q
from .constants import (
    AGENT_COUNT,
    BOARD_SIZE,
    BOMB_DEFAULT_STRENGTH,
    BOMB_LIFETIME,
    C_AGENT0,
    C_BOMB,
    C_EXTRABOMB,
    C_INCRRANGE,
    C_KICK,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    MAX_BOMBS,
    MAX_FLAMES,
    NUM_CELLS,
)

I32 = torch.int32


class Bombs(NamedTuple):
    """Bomb queue fields (SoA); logical order via ``State.bomb_head`` /
    ``bomb_count``."""

    x: torch.Tensor         # i32[B, MAX_BOMBS]
    y: torch.Tensor         # i32[B, MAX_BOMBS]
    id: torch.Tensor        # i32[B, MAX_BOMBS] owner agent
    strength: torch.Tensor  # i32[B, MAX_BOMBS] blast radius (stored at plant)
    timer: torch.Tensor     # i32[B, MAX_BOMBS] ticks until explosion
    dir: torch.Tensor       # i32[B, MAX_BOMBS] movement direction (0 = idle)
    moved: torch.Tensor     # bool[B, MAX_BOMBS] "moved this step" flag


class Flames(NamedTuple):
    """Flame queue fields (SoA); one record per exploded bomb."""

    x: torch.Tensor         # i32[B, MAX_FLAMES] origin x
    y: torch.Tensor         # i32[B, MAX_FLAMES] origin y
    timer: torch.Tensor     # i32[B, MAX_FLAMES] time left
    strength: torch.Tensor  # i32[B, MAX_FLAMES] ray length


class State(NamedTuple):
    """Queue-encoded boards: planes, agents, queues, scalars."""

    board: torch.Tensor       # i32 cell class (C_* codes)
    hidden_pow: torch.Tensor  # i32 powerup flag under WOOD / carried by FLAME
    flame_sig: torch.Tensor   # i32 owner signature (origin index) of FLAME

    agent_x: torch.Tensor
    agent_y: torch.Tensor
    agent_bomb_count: torch.Tensor
    agent_max_bombs: torch.Tensor
    agent_strength: torch.Tensor
    agent_can_kick: torch.Tensor  # bool
    agent_dead: torch.Tensor      # bool

    bombs: Bombs
    bomb_head: torch.Tensor
    bomb_count: torch.Tensor

    flames: Flames
    flame_head: torch.Tensor
    flame_count: torch.Tensor

    timestep: torch.Tensor
    alive_count: torch.Tensor


def empty_state(b: int | None = None, device=None) -> State:
    """All-passage boards, agents at (0, 0) alive with default stats, empty
    queues, on ``device`` (None: the card).

    ``b`` boards with a leading batch axis; ``b=None`` is one board without
    it (the form ``to_state`` and the renderer use).  Matches a
    value-initialised reference ``State``."""
    from ..device import resolve_device

    device = resolve_device(device)
    lead = () if b is None else (b,)

    def zeros(*n, dtype=I32):
        return torch.zeros(lead + n, dtype=dtype, device=device)

    zb, zf = (lambda: zeros(MAX_BOMBS)), (lambda: zeros(MAX_FLAMES))
    return State(
        board=zeros(NUM_CELLS), hidden_pow=zeros(NUM_CELLS),
        flame_sig=zeros(NUM_CELLS),
        agent_x=zeros(AGENT_COUNT), agent_y=zeros(AGENT_COUNT),
        agent_bomb_count=zeros(AGENT_COUNT),
        agent_max_bombs=zeros(AGENT_COUNT) + 1,
        agent_strength=zeros(AGENT_COUNT) + BOMB_DEFAULT_STRENGTH,
        agent_can_kick=zeros(AGENT_COUNT, dtype=torch.bool),
        agent_dead=zeros(AGENT_COUNT, dtype=torch.bool),
        bombs=Bombs(zb(), zb(), zb(), zb(), zb(), zb(),
                    zeros(MAX_BOMBS, dtype=torch.bool)),
        bomb_head=zeros(), bomb_count=zeros(),
        flames=Flames(zf(), zf(), zf(), zf()),
        flame_head=zeros(), flame_count=zeros(),
        timestep=zeros(), alive_count=zeros() + AGENT_COUNT,
    )


def map_state(fn, *states: State) -> State:
    """Apply ``fn`` leaf-wise over one or more ``State``s."""
    first = states[0]
    out = {}
    for k, name in enumerate(State._fields):
        leaves = [s[k] for s in states]
        if name in ("bombs", "flames"):
            out[name] = type(first[k])(*(fn(*ls) for ls in zip(*leaves)))
        else:
            out[name] = fn(*leaves)
    return State(**out)


def state_of(s: State, i: int) -> State:
    """Board ``i`` of a batch, without its batch axis (beside
    ``engine.cellular.board_of``)."""
    return map_state(lambda t: t[i], s)


def stack_states(states) -> State:
    """The one-board ``State``s stacked into a batch."""
    return map_state(lambda *ts: torch.stack(ts), *states)


def cell_index(x, y):
    """Flat board index of (x, y)."""
    return x + BOARD_SIZE * y


def board_get(state, x, y) -> torch.Tensor:
    """The cell class at (x, y) on every board: ``[B]``; ``x`` and ``y``
    are ints or ``[B]`` tensors inside the board."""
    return read_at(state.board, cell_index(x, y))


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


def write_at(arr, i, value, mask=None):
    """``arr[b, i[b]] = value[b]`` where ``mask``; ``i`` as for
    ``read_at``; ``value`` a scalar or ``[B]``."""
    if isinstance(i, int):
        i = torch.full(arr.shape[:1], i, dtype=torch.long, device=arr.device)
    idx = index_col(i)
    if mask is not None:
        value = torch.where(mask, value, arr.gather(1, idx)[:, 0])
    if isinstance(value, torch.Tensor):
        return arr.scatter(1, idx, value.to(arr.dtype)[:, None])
    return arr.scatter(1, idx, value)


def add_at(arr, i, value, mask=None):
    """``arr[b, i[b]] += value`` where ``mask`` (JAX ``.at[].add``)."""
    return write_at(arr, i, read_at(arr, i) + value, mask)


def _clamp_index(i, n: int):
    """JAX's gather index: negative indices in [-n, 0) wrap, the rest
    clamp into [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def read_clamped(arr, i):
    """``read_at`` for an index that may lie outside [0, N): read as JAX
    reads it (``_clamp_index``)."""
    i = torch.as_tensor(i, device=arr.device).expand(arr.shape[0])
    return read_at(arr, _clamp_index(i, arr.shape[1]))


def dropping_index(i, n: int, b: int, mask=None):
    """JAX's ``.at[i].set`` on ``[B, n]``: the clamped index and the mask of
    the boards whose write lands (an index in [-n, 0) wraps, one outside
    [-n, n) is dropped).  Shared by ``write_dropping`` and the writes of
    several planes at one cell."""
    i = torch.as_tensor(i).expand(b)
    ok = (i >= -n) & (i < n)
    return _clamp_index(i, n), ok if mask is None else mask & ok


def write_dropping(arr, i, value, mask=None):
    """``write_at`` for an index that may lie outside [0, N): JAX's
    ``.at[i].set`` wraps an index in [-N, 0) and drops one outside
    [-N, N); so is the write here."""
    idx, ok = dropping_index(torch.as_tensor(i, device=arr.device),
                             arr.shape[1], arr.shape[0], mask)
    return write_at(arr, idx, value, ok)


def is_out_of_bounds(x, y):
    """Reference util::IsOutOfBounds (step_utility.hpp:155-166)."""
    return (x < 0) | (y < 0) | (x >= BOARD_SIZE) | (y >= BOARD_SIZE)


# --- Cell-class predicates (reference bboard.hpp:73-109) ---------------------


def is_powerup(c):
    return (c >= C_EXTRABOMB) & (c <= C_KICK)


def is_agent(c):
    return c >= C_AGENT0


def is_walkable(c):
    return is_powerup(c) | (c == C_PASSAGE)


def is_static_mov_block(c):
    """Walls, wood and powerups block bomb movement (bboard.hpp:94-97)."""
    return (c == C_WOOD) | is_powerup(c) | (c == C_RIGID)


def flag_item(pwp):
    """Powerup flag -> cell class (reference State::FlagItem, bboard.cpp:182)."""
    out = torch.full_like(pwp, C_PASSAGE)
    out = torch.where(pwp == 1, C_EXTRABOMB, out)
    out = torch.where(pwp == 2, C_INCRRANGE, out)
    return torch.where(pwp == 3, C_KICK, out)


# --- Agent / item placement ---------------------------------------------------


def put_item(state: State, x, y, item, mask=None) -> State:
    return state._replace(
        board=write_dropping(state.board, cell_index(x, y), item, mask))


def put_agent(state: State, x, y, agent_id, mask=None) -> State:
    """Reference State::PutAgent (bboard.cpp:313-320)."""
    agent_id = torch.as_tensor(agent_id, device=state.board.device)
    return state._replace(
        board=write_dropping(state.board, cell_index(x, y),
                             C_AGENT0 + agent_id, mask),
        agent_x=write_at(state.agent_x, agent_id, x, mask),
        agent_y=write_at(state.agent_y, agent_id, y, mask),
    )


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


def kill(state: State, agent_id, mask=None) -> State:
    """Reference State::Kill (bboard.hpp:474-481): idempotent, alive-- once."""
    do = torch.ones_like(state.alive_count, dtype=torch.bool) \
        if mask is None else mask
    was_dead = read_at(state.agent_dead, agent_id)
    return state._replace(
        agent_dead=write_at(state.agent_dead, agent_id, True, do),
        alive_count=state.alive_count - (do & ~was_dead).to(I32),
    )


def kill_many(state: State, *agent_ids) -> State:
    for a in agent_ids:
        state = kill(state, a)
    return state


# --- Bomb queue scans (reference bboard.cpp:265-311) --------------------------


def _first_index(m):
    """First True index along the last axis, or -1 (``jnp.argmax`` of the
    int mask: 0 for an all-False row, hence the ``any``)."""
    return torch.where(m.any(-1), m.to(I32).argmax(-1).to(I32), -1)


def _col(v):
    """A per-board value as a column against ``[B, N]`` arrays."""
    v = torch.as_tensor(v)
    return v[:, None] if v.dim() == 1 else v


def _logical_index(head, n: int):
    """``[B, N]``: the logical index of each physical slot."""
    return (torch.arange(n, device=head.device) - head[:, None]) % n


def _bomb_pos_match(state: State, x, y):
    """Per-PHYSICAL-slot match mask ``[B, 20]`` for live bombs at (x, y)
    and each slot's logical index."""
    r = _logical_index(state.bomb_head, MAX_BOMBS)
    m = ((r < state.bomb_count[:, None]) & (state.bombs.x == _col(x))
         & (state.bombs.y == _col(y)))
    return m, r


def has_bomb(state: State, x, y):
    """Reference State::HasBomb (bboard.cpp:265-275)."""
    return _bomb_pos_match(state, x, y)[0].any(1)


def get_bomb_index(state: State, x, y):
    """First logical bomb index at (x, y), or -1 (bboard.cpp:301-311):
    the least logical index over the matching slots."""
    m, r = _bomb_pos_match(state, x, y)
    first = torch.where(m, r, MAX_BOMBS).amin(1)
    return torch.where(first < MAX_BOMBS, first, -1).to(I32)


def get_agent(state: State, x, y):
    """First *alive* agent at (x, y), or -1 (bboard.cpp:289-299)."""
    return _first_index(~state.agent_dead & (state.agent_x == _col(x))
                        & (state.agent_y == _col(y)))


def bomb_at(state: State, i) -> Bombs:
    """All fields of logical bomb ``i``, ``[B]`` each."""
    return Bombs(*q.get_many(state.bombs, state.bomb_head, i))


def set_bomb_field(state: State, i, field: str, value, mask=None) -> State:
    b = state.bombs._asdict()
    b[field] = q.set_(b[field], state.bomb_head, i, value, mask)
    return state._replace(bombs=Bombs(**b))


def plant_bomb(state: State, x, y, agent_id, set_item=False,
               life=BOMB_LIFETIME, mask=None) -> State:
    """Reference State::PlantBombModifiedLife (bboard.cpp:125-146).

    Refuses when the agent is at max bombs.  Writes id/pos/strength/time into
    the next slot but leaves the slot's stale direction/moved flags untouched
    (the reference never resets them -- a recycled slot can leak a
    direction).  ``set_item`` is a bool or a per-board bool tensor.
    """
    dev = state.board.device
    agent_id = torch.as_tensor(agent_id, device=dev)
    ok = read_at(state.agent_bomb_count, agent_id) \
        < read_at(state.agent_max_bombs, agent_id)
    if mask is not None:
        ok = ok & mask
    bombs, _, count = q.append(
        state.bombs,
        Bombs(x=x, y=y, id=agent_id,
              strength=read_at(state.agent_strength, agent_id), timer=life,
              dir=None,     # stale-slot quirk: direction not reset
              moved=None),  # stale-slot quirk: moved flag not reset
        state.bomb_head, state.bomb_count, MAX_BOMBS, ok,
    )
    item = ok & torch.as_tensor(set_item, device=dev)
    return state._replace(
        bombs=bombs, bomb_count=count,
        board=write_dropping(state.board, cell_index(x, y), C_BOMB, item),
        agent_bomb_count=add_at(state.agent_bomb_count, agent_id, 1, ok),
    )


def remove_bomb(state: State, i, mask=None) -> State:
    """FixedQueue::RemoveAt on the bomb queue (bboard.hpp:151-160)."""
    bombs, head, count = q.remove_at(
        state.bombs, state.bomb_head, state.bomb_count, i, MAX_BOMBS, mask)
    return state._replace(bombs=bombs, bomb_head=head, bomb_count=count)


def pop_bomb(state: State, mask=None) -> State:
    """PopBomb proxy (bboard.cpp:93-97): front owner's bombCount--, pop front.

    The owner id is read from the front slot, which may be stale when the
    queue is empty: the read is clamped (``read_at``) as JAX clamps it."""
    owner = q.get(state.bombs.id, state.bomb_head, 0)
    head, count = q.pop_front(state.bomb_head, state.bomb_count, MAX_BOMBS,
                              mask)
    return state._replace(
        agent_bomb_count=add_at(state.agent_bomb_count, owner, -1, mask),
        bomb_head=head, bomb_count=count,
    )

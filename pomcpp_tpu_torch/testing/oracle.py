"""Host side of the C++ parity oracle (``tools/oracle_dump.cpp``).

Counterpart of ``pomcpp_tpu.testing.oracle``.  ``ensure_oracle`` builds the
unmodified reference engine out of tree with ``tools/build_oracle.sh``
into ``build/oracle_dump``; ``oracle_board``, ``oracle_traj``,
``enum2_pair`` and ``enum3_trio`` run it on the host with injected
boards, move streams and states; ``state_to_dump`` / ``states_to_dumps``
turn the port's queue-encoded ``State`` into the reference's raw ``Item``
dump (reference encoding: include/bboard.hpp:54-71, 98-108), byte for byte
the JAX package's, so that whole trajectories and sweeps diff bit for bit.

``state_to_dump`` reads ONE board (``core.state.state_of(s, i)``, tensors
on any device or numpy arrays); ``states_to_dumps`` reads a batch, fetching
each field to the host once.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from typing import Any

import numpy as np

from ..core.constants import (
    BOARD_SIZE,
    C_AGENT0,
    C_BOMB,
    C_EXTRABOMB,
    C_FLAME,
    C_INCRRANGE,
    C_KICK,
    C_PASSAGE,
    C_RIGID,
    C_WOOD,
    MAX_BOMBS,
    MAX_FLAMES,
)
from .divergence import _np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORACLE_BIN = os.path.join(_REPO, "build", "oracle_dump")
_BUILD_SCRIPT = os.path.join(_REPO, "tools", "build_oracle.sh")

_RAW_FLAMES = 4 << 16
_RAW_WOOD = 2 << 8
_RAW_AGENT0 = 1 << 24


def _reference_header() -> str:
    """The reference's ``bboard.hpp``, in the include directory that the
    build script compiles against (its ``-I`` flag): the script is the one
    place that names where the reference's sources live, and it is read
    only when the oracle is asked for."""
    with open(_BUILD_SCRIPT) as f:
        include = re.search(r"-I(\S+)", f.read()).group(1)
    return os.path.join(include, "bboard.hpp")


def ensure_oracle() -> str | None:
    """Build the oracle if missing; its path, or None if unbuildable (the
    reference's sources are absent or the build fails)."""
    if os.path.exists(ORACLE_BIN):
        return ORACLE_BIN
    if not os.path.exists(_reference_header()):
        return None
    r = subprocess.run(["sh", _BUILD_SCRIPT], capture_output=True, text=True)
    if r.returncode != 0:
        return None
    return ORACLE_BIN


def oracle_board(seed: int) -> np.ndarray:
    """Raw board ints after InitBoardItems(seed)."""
    out = subprocess.run([ORACLE_BIN, "board", hex(seed)],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    return np.asarray(json.loads(out.stdout), np.int64)


def oracle_traj(seed: int, moves: np.ndarray, kick: bool = False) -> list:
    """Run ``moves`` ([steps, 4] ints) through the reference; one dump per
    step.  Returns the initial state plus one dump per executed step; the
    oracle stops early once aliveAgents <= 1 (after dumping that state)."""
    stream = "\n".join(" ".join(str(int(m)) for m in row) for row in moves)
    out = subprocess.run(
        [ORACLE_BIN, "kicktraj" if kick else "traj", hex(seed),
         str(len(moves))],
        input=stream, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.strip()]


def _raw_boards(board, hidden, sig) -> np.ndarray:
    """int64 [B, 121]: the reference's raw item of every cell."""
    board = board.astype(np.int64)
    hidden = hidden.astype(np.int64)
    raw = np.zeros(board.shape, np.int64)
    for code, item in ((C_PASSAGE, 0), (C_RIGID, 1), (C_BOMB, 3),
                       (C_EXTRABOMB, 6), (C_INCRRANGE, 7), (C_KICK, 8)):
        raw[board == code] = item
    wood = board == C_WOOD
    raw[wood] = _RAW_WOOD + hidden[wood]
    # Reference flame cells: FLAMES | (origin index << 3) | (powflag & 0b11)
    # (bboard.cpp:44-51, 206-210).
    flame = board == C_FLAME
    raw[flame] = (_RAW_FLAMES + (sig.astype(np.int64)[flame] << 3)
                  + (hidden[flame] & 0b11))
    ag = board >= C_AGENT0
    raw[ag] = _RAW_AGENT0 + (board[ag] - C_AGENT0)
    return raw


def _logical_rows(fields, head, count, size: int) -> list:
    """Per board, the queue's live records in logical order (physical slot
    ``(head + i) % size`` for ``i < count``), each a list of ints."""
    live = int(count.max(initial=0))
    slots = (head[:, None] + np.arange(live)) % size
    rows = np.stack([np.take_along_axis(f.astype(np.int64), slots, 1)
                     for f in fields], -1).tolist()
    return [r[:c] for r, c in zip(rows, count.tolist())]


def states_to_dumps(s) -> list[dict[str, Any]]:
    """The oracle's dump of every board of a batched ``State``."""
    raw = _raw_boards(_np(s.board), _np(s.hidden_pow), _np(s.flame_sig))
    agents = np.stack([_np(f).astype(np.int64) for f in (
        s.agent_x, s.agent_y, s.agent_dead, s.agent_bomb_count,
        s.agent_max_bombs, s.agent_strength, s.agent_can_kick)], -1)
    b = s.bombs
    bombs = _logical_rows([_np(f) for f in (b.x, b.y, b.id, b.strength,
                                             b.timer, b.dir)],
                          _np(s.bomb_head), _np(s.bomb_count), MAX_BOMBS)
    f = s.flames
    flames = _logical_rows([_np(v) for v in (f.x, f.y, f.timer, f.strength)],
                           _np(s.flame_head), _np(s.flame_count), MAX_FLAMES)
    alive = _np(s.alive_count).astype(np.int64).tolist()
    return [{"board": r, "agents": a, "bombs": bm, "flames": fl, "alive": n}
            for r, a, bm, fl, n in zip(raw.tolist(), agents.tolist(), bombs,
                                       flames, alive)]


def state_to_dump(s) -> dict[str, Any]:
    """The oracle's dump of ONE board (``state_of(s, i)``: no batch axis)."""
    one = type(s)(*(type(v)(*(_np(t)[None] for t in v)) if name in (
        "bombs", "flames") else _np(v)[None]
        for name, v in zip(s._fields, s)))
    return states_to_dumps(one)[0]


def dump_to_text(dump: dict) -> str:
    """Serialize a dump to the oracle's ``loadenum2`` stdin format."""
    parts = [" ".join(str(int(v)) for v in dump["board"])]
    for a in dump["agents"]:
        parts.append(" ".join(str(int(v)) for v in a))
    parts.append(str(len(dump["bombs"])))
    for b in dump["bombs"]:
        parts.append(" ".join(str(int(v)) for v in b))
    parts.append(str(len(dump["flames"])))
    for f in dump["flames"]:
        parts.append(" ".join(str(int(v)) for v in f))
    parts.append(str(int(dump["alive"])))
    return "\n".join(parts) + "\n"


def _run_enum(args: list, dump: dict, expect: int, timeout: int):
    out = subprocess.run([ORACLE_BIN, *map(str, args)],
                         input=dump_to_text(dump), capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr
    dumps = [json.loads(line) for line in out.stdout.splitlines()
             if line.strip()]
    assert len(dumps) == expect + 1, len(dumps)
    return dumps[0], dumps[1:]


def enum2_pair(dump: dict, agent_a: int, agent_b: int):
    """The oracle's 2-step 36x36 joint-move sweep over two agents on an
    injected state.  Returns ``(echoed_base, [1296 dumps])``: sweep index
    ``code`` applies step-1 moves ``(code%36 % 6, code%36 // 6)`` and
    step-2 moves ``(code//36 % 6, code//36 // 6)`` to ``(agent_a,
    agent_b)`` (other agents IDLE)."""
    return _run_enum(["loadenum2", agent_a, agent_b], dump, 1296, 300)


def enum3_trio(dump: dict, agent_a: int, agent_b: int, agent_c: int,
               n_moves: int = 5):
    """The oracle's 2-step (n_moves^3)^2 sweep over THREE agents on an
    injected state (``n_moves=5``: IDLE + directions; 6 adds BOMB).
    Returns ``(echoed_base, [n^6 dumps])``; sweep index ``code`` applies
    step-1 moves ``(c1%n, c1//n%n, c1//n^2)`` with ``c1 = code % n^3`` and
    step-2 moves likewise from ``code // n^3`` to ``(agent_a, agent_b,
    agent_c)`` (the fourth agent IDLE)."""
    return _run_enum(["loadenum3", agent_a, agent_b, agent_c, n_moves],
                     dump, n_moves ** 6, 600)


def diff_dumps(ref: dict, mine: dict) -> list[str]:
    """Human-readable field-level differences between two dumps."""
    if ref == mine:     # the common case in a sweep, and the cheap test
        return []
    out = []
    rb, mb = np.asarray(ref["board"]), np.asarray(mine["board"])
    for c in np.nonzero(rb != mb)[0]:
        out.append(
            f"board[{c}] (x={c % BOARD_SIZE},y={c // BOARD_SIZE}): "
            f"ref={rb[c]:#x} mine={mb[c]:#x}"
        )
    for k in ("agents", "bombs", "flames", "alive"):
        if ref[k] != mine[k]:
            out.append(f"{k}: ref={ref[k]} mine={mine[k]}")
    return out


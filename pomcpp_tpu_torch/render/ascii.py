"""Host-side terminal renderer (reference PrintState, bboard.cpp:403-489).

Counterpart of ``pomcpp_tpu.render.ascii``, character for character: one
board as 3-character glyphs (optionally coloured), a side panel with each
agent's position and powerups beside the top rows, then the bomb and flame
queues.  It reads one board of either encoding -- a queue-encoded ``State``
(``core.state``) or a ``CellState`` without a batch axis
(``engine.cellular.board_of``) -- from tensors on any device or numpy
arrays, fetching each field to the host once.  Never on the compute path.

``render_rmap`` and ``render_path`` draw ONE board's reachability map
(``strategy.rmap.fill_rmap``: take a board's row of each field), and
``render_dependency`` / ``render_dependency_chain`` one board's movement
dependency and root arrays (``engine.util.resolve_dependencies``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import (
    AGENT_COUNT,
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

_RESET = "\033[0m"
_AGENT_COLORS = ("\033[0;31m", "\033[0;34m", "\033[0;32m", "\033[0;33m")
_GLYPHS = {
    C_PASSAGE: "   ",
    C_RIGID: "[X]",
    C_WOOD: "[□]",
    C_BOMB: " ● ",
    C_FLAME: " ♨ ",
    C_EXTRABOMB: " b ",
    C_INCRRANGE: " r ",
    C_KICK: " k ",
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _glyph(item: int, color: bool) -> str:
    """3-char cell glyph (reference PrintItem, bboard.cpp:452-489)."""
    if item >= C_AGENT0:
        aid = item - C_AGENT0
        s = f" {aid} "
        return f"{_AGENT_COLORS[aid % 4]}{s}{_RESET}" if color else s
    s = _GLYPHS.get(item, " ? ")
    if color and item == C_FLAME:
        return f"\033[0;31m{s}{_RESET}"
    return s


def _queue_items(xs, ys, ts, head: int, count: int, size: int) -> list:
    return [f"({xs[(head + i) % size]},{ys[(head + i) % size]})"
            f"t{ts[(head + i) % size]}" for i in range(count)]


def _plane_items(timer) -> list:
    return [f"({c % BOARD_SIZE},{c // BOARD_SIZE})t{timer[c]}"
            for c in np.nonzero(timer > 0)[0]]


def render_state(state, color: bool = True) -> str:
    """One board and its agent / bomb / flame panel as a string."""
    is_cell = not hasattr(state, "bombs")
    board = _np(state.board).reshape(BOARD_SIZE, BOARD_SIZE)
    ax, ay, dead = _np(state.agent_x), _np(state.agent_y), _np(state.agent_dead)
    mb, st = _np(state.agent_max_bombs), _np(state.agent_strength)
    kick = _np(state.agent_can_kick)

    lines = []
    for y in range(BOARD_SIZE):
        row = "".join(_glyph(int(board[y, x]), color)
                      for x in range(BOARD_SIZE))
        panel = ""
        if y < AGENT_COUNT:
            i = y
            status = "DEAD" if dead[i] else f"({int(ax[i])},{int(ay[i])})"
            panel = (f"   agent {i} {status} bombs:{int(mb[i])} "
                     f"range:{int(st[i])} kick:{int(kick[i])}")
        elif y == AGENT_COUNT + 1:
            if is_cell:
                items = _plane_items(_np(state.bomb_timer))
            else:
                b = state.bombs
                items = _queue_items(_np(b.x), _np(b.y), _np(b.timer),
                                     int(_np(state.bomb_head)),
                                     int(_np(state.bomb_count)), MAX_BOMBS)
            panel = "   bombs: " + " ".join(items)
        elif y == AGENT_COUNT + 2:
            if is_cell:
                items = _plane_items(_np(state.flame_timer))
            else:
                f = state.flames
                items = _queue_items(_np(f.x), _np(f.y), _np(f.timer),
                                     int(_np(state.flame_head)),
                                     int(_np(state.flame_count)), MAX_FLAMES)
            panel = "   flames: " + " ".join(items)
        lines.append("║" + row + "║" + panel)

    top = "╔" + "═" * (3 * BOARD_SIZE) + "╗"
    bot = "╚" + "═" * (3 * BOARD_SIZE) + "╝"
    ts = int(_np(state.timestep))
    alive = int(_np(state.alive_count))
    return "\n".join([top] + lines + [bot, f"t={ts} alive={alive}"])


def print_state(state, color: bool = True, clear: bool = False) -> None:
    if clear:
        print("\033c", end="")
    print(render_state(state, color))


def render_rmap(rmap, color: bool = True) -> str:
    """One board's RMap distances (reference PrintMap,
    strategy.cpp:251-265)."""
    dist = _np(rmap.dist).reshape(BOARD_SIZE, BOARD_SIZE)
    return "\n".join(" ".join(f"{int(dist[y, x]):2d}"
                              for x in range(BOARD_SIZE))
                     for y in range(BOARD_SIZE))


def render_path(rmap, target: int, color: bool = True) -> str:
    """Distances with the predecessor path to ``target`` highlighted
    (reference PrintPath, strategy.cpp:268-294): the walk stops at the
    source or after 121 cells."""
    dist = _np(rmap.dist).reshape(BOARD_SIZE, BOARD_SIZE)
    pred = _np(rmap.pred)
    src = int(_np(rmap.source))
    path = set()
    cur = int(target)
    for _ in range(BOARD_SIZE * BOARD_SIZE):
        if cur == src:
            break
        path.add(cur)
        cur = int(pred[cur])
    red, reset = ("\033[0;31m", _RESET) if color else ("", "")
    lines = []
    for y in range(BOARD_SIZE):
        row = []
        for x in range(BOARD_SIZE):
            d = f"{int(dist[y, x]):2d}"
            row.append(f"{red}{d}{reset}" if x + BOARD_SIZE * y in path else d)
        lines.append(" ".join(row))
    return "\n".join(lines)


def render_dependency(dependency) -> str:
    """One board's movement dependency array, one ``[i <- j]`` line per
    agent (reference PrintDependency, step_utility.cpp:339-354)."""
    dep = _np(dependency)
    return "\n".join(f"[{i} <- ]" if int(d) == -1 else f"[{i} <- {int(d)}]"
                     for i, d in enumerate(dep))


def render_dependency_chain(dependency, chain) -> str:
    """Each of one board's movement chains walked root to tail,
    ``r <- a <- b`` a line (reference PrintDependencyChain,
    step_utility.cpp:356-371); ``chain`` is the board's roots row."""
    dep = _np(dependency)
    lines = []
    for c in _np(chain):
        c = int(c)
        if c == -1:
            continue
        parts = [str(c)]
        k = int(dep[c])
        while k != -1:
            parts.append(str(k))
            k = int(dep[k])
        lines.append(" <- ".join(parts))
    return "\n".join(lines)

"""Attribution of cellular-vs-exact mismatches to the documented divergence
classes (``engine.cellular`` header, classes 1-4).

Counterpart of ``pomcpp_tpu.testing.divergence``, on the host in numpy.  The
plane engine substitutes four explicit rule choices for reference queue
artifacts (stacked plants, stale plant directions, DFS chain ordering,
queue-order pileups); ``divergence_classes`` inspects a transition's
*preconditions* and reports which classes could explain a mismatch on it.
``divergence_census`` measures how often each class fires in real play.
"""

from __future__ import annotations

import numpy as np

from ..core.constants import M_BOMB, MAX_BOMBS


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def divergence_classes(pre, mv, post_exact, pre_exact=None) -> list[str]:
    """Which documented divergence classes (1-4) could explain a mismatch on
    this transition, from its *preconditions*.

    ``pre`` / ``post_exact`` are one-board ``CellState``s (the exact
    engine's pre/post states in plane form, ``engine.cellular.board_of``),
    ``mv`` the 4 moves.  ``pre_exact`` (optional) is the exact
    queue-encoded ``State`` of that board pre-step (``core.state.state_of``):
    it sharpens class 2 to cover stale-direction plants whose bomb slides
    into a flame and explodes the same step.
    """
    mv = _np(mv)
    classes = []
    cells = _np(pre.agent_x) + 11 * _np(pre.agent_y)
    alive = ~_np(pre.agent_dead)
    pre_bt = _np(pre.bomb_timer)
    post_bt = _np(post_exact.bomb_timer)
    can_plant = (
        (mv == M_BOMB)
        & alive
        & (_np(pre.agent_bomb_count) < _np(pre.agent_max_bombs))
    )
    # 1: plant onto a cell already holding a bomb (reference stacks them).
    if np.any(can_plant & (pre_bt[cells] > 0)):
        classes.append("1:stacked-plant")
    # 2: fresh plant in a recycled queue slot inherits a stale direction.
    new_bomb = (post_bt > 0) & (pre_bt == 0)
    if np.any(new_bomb & (_np(post_exact.bomb_dir) != 0)):
        classes.append("2:stale-plant-direction")
    elif pre_exact is not None and np.any(can_plant):
        # The j-th plant this step lands in raw slot (head + count + j) %
        # MAX_BOMBS (PlantBomb appends, bboard.cpp:125-146, recycling the
        # slot's last direction); a stale dir there can make the fresh bomb
        # slide into a flame and explode the SAME step.
        head = int(_np(pre_exact.bomb_head))
        count = int(_np(pre_exact.bomb_count))
        dirs = _np(pre_exact.bombs.dir)
        j = 0
        for i in range(4):
            if can_plant[i]:
                if dirs[(head + count + j) % MAX_BOMBS] != 0:
                    classes.append("2:stale-plant-direction")
                    break
                j += 1
    # 3: >=2 bombs exploded this step -> BFS-vs-DFS chain ordering.
    if np.sum((pre_bt > 0) & (post_bt == 0)) >= 2:
        classes.append("3:multi-bomb-chain")
    # 4: bomb PILEUP ordering (cell-order counting vs the reference's
    # queue-windowed scan): (a) >=2 bombs moving/kicked this step, or (b) a
    # single kicked bomb whose slide target already holds a STATIONARY bomb.
    pre_moving = _np(pre.bomb_dir) != 0
    dx = np.array([0, 0, 0, -1, 1])[np.clip(mv, 0, 4)] * (mv <= 4)
    dy = np.array([0, -1, 1, 0, 0])[np.clip(mv, 0, 4)] * (mv <= 4)
    tx = np.clip(_np(pre.agent_x) + dx, 0, 10)
    ty = np.clip(_np(pre.agent_y) + dy, 0, 10)
    kick_cand = (
        alive
        & _np(pre.agent_can_kick)
        & (mv >= 1)
        & (mv <= 4)
        & (pre_bt[tx + 11 * ty] > 0)
    )
    if np.sum(pre_moving) + np.sum(kick_cand) >= 2:
        classes.append("4:multi-bomb-pileup")
    else:
        # (b): the kicked bomb's own slide target (one further along the
        # kick direction, when in bounds) holds another bomb.
        for i in range(4):
            if not kick_cand[i]:
                continue
            bx, by = tx[i] + dx[i], ty[i] + dy[i]
            if 0 <= bx <= 10 and 0 <= by <= 10 and pre_bt[bx + 11 * by] > 0:
                classes.append("4:multi-bomb-pileup")
                break
    return classes

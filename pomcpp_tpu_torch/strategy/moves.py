"""The move-queue helpers of ``pomcpp_tpu.strategy.moves`` the SimpleAgent
needs: ``safe_condition`` and ``sort_directions`` (strategy.hpp:130-152,
strategy.cpp:192-195), batched over any leading axes.
"""

from __future__ import annotations

import torch

from ..engine.util import desired_position

SORT_APPLICATIONS = 8   # <= 4 original entries + <= 4 removals


def safe_condition(danger, min_time: int = 2):
    """_safe_condition (strategy.cpp:192-195)."""
    return (danger == 0) | (danger >= min_time)


def sort_directions(slots, count, rp_x, rp_y, rp_head, rp_count, x, y):
    """SortDirections over the persistent 4-slot queue.

    ``slots``, ``rp_x``, ``rp_y``: [..., 4]; ``count``, ``rp_head``,
    ``rp_count``, ``x``, ``y``: [...].  Replicates the reference's
    RemoveAt+AddElem aliasing exactly: a visited move that is not last in
    the queue is deleted and the element that slid into its place is
    duplicated at the back; a visited move at the back stays put.  Returns
    ``(slots, count)``.
    """
    k = torch.arange(4, device=slots.device)
    logical = (rp_head[..., None] + k) % 4
    ring_x = rp_x.gather(-1, logical.long())
    ring_y = rp_y.gather(-1, logical.long())
    ring_live = k < rp_count[..., None]
    count_orig = count
    i = torch.zeros_like(count)
    removes = torch.zeros_like(count)
    for _ in range(SORT_APPLICATIONS):
        active = (i < count_orig) & (removes < 4) & (i >= 0)
        si = i.clamp(0, 3).long()[..., None]
        v = slots.gather(-1, si)[..., 0].clamp(0, 5)
        dx, dy = desired_position(x, y, v)
        vis = (ring_live & (ring_x == dx[..., None])
               & (ring_y == dy[..., None])).any(-1)
        do = active & vis
        # RemoveAt(i): shift logical (i, count) left by one.
        shift = (k >= i[..., None]) & (k < count[..., None] - 1)
        shifted = torch.where(shift, torch.roll(slots, -1, -1), slots)
        count2 = count - 1
        # AddElem(q[i]) after the shift (the aliasing quirk).
        val = shifted.gather(-1, si)
        appended = shifted.scatter(-1, count2.clamp(0, 3).long()[..., None],
                                   val)
        slots = torch.where(do[..., None], appended, slots)
        count = torch.where(do, count2 + 1, count)
        i = torch.where(do, i - 1, i) + 1
        removes = removes + do.to(removes.dtype)
    return slots, count

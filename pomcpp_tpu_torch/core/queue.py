"""Fixed-capacity circular queues over structure-of-arrays fields, batched.

Counterpart of ``pomcpp_tpu.core.queue``.  A queue is a set of field arrays
``[B, N]`` plus per-board ``head`` / ``count`` (``[B]``); logical index ``i``
of board ``b`` lives at physical slot ``(head[b] + i) % N``.  The physical
layout is observable -- a recycled slot keeps stale contents, which the
reference leaks into a fresh plant (``core.state.plant_bomb``) -- so every
operation keeps it exactly.

Indices are per-board tensors ``[B]`` (or Python ints).  ``%`` on tensors
is floor mod, so a negative logical index (``q.get`` with ``i = -1``) reads
slot ``(head - 1) % N`` as JAX does; ``torch.fmod`` would go negative.

Every operation that writes takes an optional ``mask`` (bool ``[B]``):
boards where it is False are left bit for bit as they were.  This is how
the port runs a per-board ``lax.cond`` arm on the whole batch.
"""

from __future__ import annotations

import torch


def slot(head, i, size: int):
    """Physical slot of logical index ``i`` (floor mod)."""
    return (head + i) % size


def _slot_index(field: torch.Tensor, head, i) -> torch.Tensor:
    return ((head + i) % field.shape[-1]).long().reshape(-1, 1)


def _write_slot(field: torch.Tensor, s, value, mask=None) -> torch.Tensor:
    """``field[b, s[b]] = value[b]`` where ``mask``; ``s`` is a long
    ``[B, 1]`` slot index."""
    if mask is not None:
        value = torch.where(mask, value, field.gather(1, s)[:, 0])
    if isinstance(value, torch.Tensor):
        return field.scatter(1, s, value.to(field.dtype).expand(
            field.shape[0])[:, None])
    return field.scatter(1, s, value)


def get(field: torch.Tensor, head, i) -> torch.Tensor:
    """Read logical element ``i`` of one field array ``[B, N]`` -> ``[B]``."""
    return field.gather(1, _slot_index(field, head, i))[:, 0]


def get_many(fields, head, i):
    """Logical element ``i`` of several field arrays (one slot index)."""
    s = _slot_index(fields[0], head, i)
    return [f.gather(1, s)[:, 0] for f in fields]


def set_(field: torch.Tensor, head, i, value, mask=None) -> torch.Tensor:
    """Write logical element ``i`` of one field array (where ``mask``)."""
    return _write_slot(field, _slot_index(field, head, i), value, mask)


def logical_view(field: torch.Tensor, head) -> torch.Tensor:
    """The field rotated so that logical index == array index.

    ``field`` is ``[N]`` with a scalar ``head`` (one board) or ``[B, N]``
    with ``head`` ``[B]``."""
    n = field.shape[-1]
    head = torch.as_tensor(head, device=field.device).long()
    idx = (head[..., None] + torch.arange(n, device=field.device)) % n
    return field.gather(-1, idx)


def pop_front(head, count, size: int, mask=None):
    """Advance the head (FixedQueue::PopElem, bboard.hpp:131-137).

    Slot contents are untouched (stale data stays, as in the reference).
    Returns (new_head, new_count)."""
    if mask is None:
        return (head + 1) % size, count - 1
    return (torch.where(mask, (head + 1) % size, head),
            count - mask.to(count.dtype))


def remove_at_perm(head, count, i, size: int) -> torch.Tensor:
    """Per-physical-slot masks ``[B, N]`` for FixedQueue::RemoveAt.

    RemoveAt (bboard.hpp:151-160) shifts logical elements (i, count) left by
    one; the vacated tail slot keeps a stale copy of the old last element.
    True where the slot takes the value of the next physical slot:
    ``new[k] = old[(k + 1) % N]``."""
    k = torch.arange(size, device=head.device)
    r = (k - head[:, None]) % size   # logical index of physical slot k
    i = torch.as_tensor(i, device=head.device).reshape(-1, 1)
    return (r >= i) & (r < count[:, None] - 1)


def remove_at(fields, head, count, i, size: int, mask=None):
    """Remove logical element ``i``; returns (new_fields, head, new_count).

    ``fields`` is a NamedTuple of ``[B, N]`` arrays."""
    take = remove_at_perm(head, count, i, size)
    if mask is not None:
        take = take & mask[:, None]
        count = count - mask.to(count.dtype)
    else:
        count = count - 1
    shifted = [torch.where(take, torch.roll(f, -1, 1), f) for f in fields]
    return type(fields)(*shifted), head, count


def append(fields, values, head, count, size: int, mask=None):
    """Write ``values`` into the next free slot (AddElem, bboard.hpp:144-146).

    ``values`` mirrors ``fields`` with ``[B]`` (or scalar) leaves.  A field
    whose value is ``None`` is left untouched, its stale slot included --
    how the reference leaks a recycled bomb's direction into a new plant.
    Returns (new_fields, head, new_count)."""
    s = _slot_index(fields[0], head, count)
    new = [f if v is None else _write_slot(f, s, v, mask)
           for f, v in zip(fields, values)]
    inc = 1 if mask is None else mask.to(count.dtype)
    return type(fields)(*new), head, count + inc

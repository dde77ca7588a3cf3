"""Fixed-capacity circular queues over structure-of-arrays fields.

Counterpart of ``pomcpp_tpu.core.queue``, as far as the data conversions
need it: logical index ``i`` of a queue lives at physical slot
``(head + i) % N``.  The queue operations of the exact engine (pop, remove,
append) are not ported.
"""

from __future__ import annotations

import torch


def logical_view(field: torch.Tensor, head) -> torch.Tensor:
    """The field rotated so that logical index == array index."""
    n = field.shape[0]
    idx = (torch.as_tensor(head, device=field.device).long()
           + torch.arange(n, device=field.device)) % n
    return field[idx]

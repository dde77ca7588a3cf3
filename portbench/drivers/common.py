"""What the drivers share: the run's context and record, the per-call
seeds, the host's spans and the seeded sample of a window's calls."""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable

MASK63 = (1 << 63) - 1
MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def call_seed(seed: int, k: int) -> int:
    """The non-negative 63-bit seed of call ``k`` of a run seeded ``seed``
    (``k < 0`` for the warm-up's calls)."""
    return splitmix64(splitmix64(seed & MASK64) ^ (k & MASK64)) & MASK63


@dataclasses.dataclass
class Context:
    """What a run is asked for.  ``device`` is the card on the command line;
    the tests pass the CPU, where the port's entry points run their plain
    versions.  ``calls`` ends the window after that many calls instead of
    after ``seconds`` (the tests').  ``program`` replaces the port's entry
    point (the control run, the tests' faults)."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any
    calls: int | None = None
    program: Callable | None = None


@dataclasses.dataclass
class Record:
    """What a window did.  Times are host ``time.perf_counter()`` seconds;
    ``spans`` are ``(name, start, end)`` on the wall clock (``time.time()``
    seconds), so that they lie beside the device trace, whose operations
    ``(name, start, end)`` are ``ops`` in a traced run (None otherwise);
    ``rates`` are the card's (``peaks.card_rates``)."""

    calls: int = 0
    work: float = 0.0
    first_call: float = 0.0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    enqueue_s: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    roofline: dict = dataclasses.field(default_factory=dict)
    failed: int = 0
    ops: list | None = None
    rates: Any = None
    setup_s: float = 0.0
    check_s: float = 0.0
    wall_offset: float = dataclasses.field(
        default_factory=lambda: time.time() - time.perf_counter())

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.append((name, start + self.wall_offset,
                           end + self.wall_offset))


class Sample:
    """A uniform sample of ``size`` of a window's calls, drawn from the
    run's seed as the calls come (reservoir sampling): each kept call holds
    references to its inputs and outputs, so keeping one costs the device
    nothing."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(splitmix64(seed ^ 0x5A17))
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def board_sample(seed: int, k: int, boards: int, n: int) -> list:
    """``n`` distinct board indices of call ``k``, drawn from the seed."""
    rng = random.Random(splitmix64(call_seed(seed, k) ^ 0xB0A2D))
    return sorted(rng.sample(range(boards), min(n, boards)))

"""The port's own tracing: spans at the layer boundaries of its entry
points, counters of the work its wrappers do, and the chunk kernel's phase
clocks, sampled.

Spans.  ``enable()`` turns them on, ``disable()`` off (off by default; no
environment variable or argument turns them on).  The entry points that
carry them are ``env.environment.env_step_auto_reset_batch_fsm``,
``engine.fused_step.rollout_chunk`` and ``learner.ppo.ppo_train_step``:

    env.step    -> env.args, chunk, merge
    chunk       -> chunk.args, chunk.launch, chunk.out
    merge       -> merge.args, merge.launch
    ppo.step    -> ppo.collect, ppo.gae, ppo.update
    ppo.collect -> ppo.act, env.step (each rollout step), ppo.act (bootstrap)
    ppo.act     -> ppo.features

``ppo.act`` is ``_policy_slots`` (features, the forward, the draw,
``logp``), ``ppo.features`` its features (``models.features.ego_features``:
on the card one launch of ``ego_features_kernel``); ``ppo.update`` runs
from the update's call until its last optimizer step is enqueued, before
the device has done it.  Each of the learner's functions called alone is a
root, and ``env.step`` is a root when the learner does not call it.

``chunk.args`` holds the argument checks, the conversions and the
marshalling of the launcher's arguments (``launch.chunk``), ``chunk.launch``
the ctypes launcher call and its error check, ``chunk.out`` the output
casts and the recount; ``merge`` is the env epilogue (``launch.env_merge``:
``merge.args``, then the call in ``merge.launch``).  The env step opens its
``chunk`` and ``merge`` spans itself and calls the two launch functions;
``rollout_chunk`` opens ``chunk`` and calls ``launch.chunk``.  On CPU
tensors the plain chunk runs where the card's launch would
(``chunk.launch``; no ``chunk.out``), and the plain epilogue is ``merge``
itself, with no phases.  ``rollout_chunk`` called on its own makes
``chunk`` a root.
Each span is a ``Span`` record; times are ``time.perf_counter_ns()``, the
clock of ``time.perf_counter()``.  Every span gets a fresh ``span_id``; a
child carries its parent's as ``parent_id`` (0 for a root).  A root span's
``counts`` hold the increments of ``COUNTERS`` made during it.  The records
stay in memory, the newest ``MAX_RECORDS``: ``records()`` reads them,
``clear()`` empties them.  A span site costs one global check when tracing
is off, and builds nothing.

Counters, always on:

* ``LAUNCHES``: launches per kernel on the card (keys ``_ext.KERNELS``;
  ``_ext.LAUNCHES`` is this dict);
* ``COUNTERS["host_reads"]``: host reads made by the exact engine's loops
  (``engine.flames``, ``engine.step``);
* ``COUNTERS["wrapper_ops"]``: device operations the chunk and env wrappers
  enqueue with their own PyTorch calls -- a conversion or copy that made a
  new tensor (``launch.typed``'s, and the plain paths' ``count_copies``),
  an output cast, the recount of ``alive_count`` and the timestep's advance
  (allocations are not operations);
* ``COUNTERS["model_rows"]``: rows through the actor-critic's forward in
  the learner's collect (``learner.ppo._policy_slots``, the bootstrap
  value's included), counted on the host from shapes;
* ``COUNTERS["feature_rows"]``: feature rows the feature kernel built
  (``launch.ego_features``); equal to ``model_rows`` when every act of a
  collect took the kernel;
* ``COUNTERS["update_rows"]``: rows through the forward and backward of
  ``learner.ppo.ppo_update``, each epoch counted again.

Phase clocks.  While tracing is on, every ``SAMPLE_EVERY``-th call of the
chunk launcher (``launch.chunk``) since ``enable()`` launches the chunk
kernel's clocked instance (``rollout_chunk_clocked_kernel``), which sums
each phase's warp cycles and a few event counts (``PHASES``, ``wl::Phase``
of ``csrc/step_warp.cuh``) over the call's warps into a row of its own of a
device buffer.  The buffer is zeroed when it is allocated, at the first
launcher call after ``enable()``, so a sampled call adds no device
operation and no host read.
``phase_rows()`` copies the rows to the host and tags each with its call's
``chunk`` span.  The cycles of a phase include the time a warp waited for
its turn on the SM.
"""

from __future__ import annotations

import collections
import operator
import time
from typing import NamedTuple

MAX_RECORDS = 1 << 20
SAMPLE_EVERY = 8
ROWS_PER_BLOCK = 4096

# wl::Phase of csrc/step_warp.cuh: warp-cycle sums, then event counts.
PHASES = ("draw", "danger", "bfs", "flee", "decide", "move", "bombs", "blast",
          "rest", "n_bfs_rounds", "n_bomb_steps", "n_move_passes", "n_blasts",
          "n_steps", "n_bfs_acts")

ON = False
LAUNCHES: dict = {}
COUNTERS = {"host_reads": 0, "wrapper_ops": 0, "model_rows": 0,
            "feature_rows": 0, "update_rows": 0}


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: int
    start_ns: int
    end_ns: int
    counts: dict


class PhaseRow(NamedTuple):
    span_id: int     # the sampled call's ``chunk`` span (0: none was open)
    totals: dict     # PHASES -> the call's sum over its warps


# Span records as plain tuples (``Span`` fields), made ``Span`` when read.
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
# Open spans, innermost last: [name, span_id, parent_id, start_ns,
# counter snapshot (roots) or None, is a phase].
_open: list = []
_ids = 0
_calls = 0          # chunk launcher calls since enable()
# [device buffer i64[ROWS_PER_BLOCK, len(PHASES)], rows used, device]
_blocks: list = []
_rows: list = []    # (block, row, span_id) of each sampled call


def enable() -> None:
    """Turn tracing on; the sampling count starts again if it was off."""
    global ON, _calls
    if not ON:
        _calls = 0
    ON = True


def disable() -> None:
    global ON
    ON = False


def enabled() -> bool:
    return ON


def records() -> list:
    """The span records (``Span``), oldest first."""
    return list(map(Span._make, _records))


def clear() -> None:
    """Drop the span records and the sampled rows (and their buffers)."""
    _records.clear()
    _blocks.clear()
    _rows.clear()


def count_copies(before, after) -> None:
    """Count in ``wrapper_ops`` each tensor of ``after`` that a conversion
    made anew (that is not the tensor at the same place of ``before``)."""
    COUNTERS["wrapper_ops"] += len(after) - sum(map(operator.is_, before, after))


def _close_to(depth: int, now: int) -> None:
    while len(_open) > depth:
        name, sid, parent, start, snap, _ = _open.pop()
        counts = {} if snap is None else {
            k: v - snap[k] for k, v in COUNTERS.items() if v != snap[k]}
        _records.append((name, sid, parent, start, now, counts))


def begin(name: str) -> list:
    """Open span ``name`` inside the innermost open span (after closing that
    span's open phase); returns the token ``end`` takes."""
    global _ids
    now = time.perf_counter_ns()
    if _open and _open[-1][5]:
        _close_to(len(_open) - 1, now)
    _ids += 1
    parent = _open[-1][1] if _open else 0
    span = [name, _ids, parent, now, None if _open else dict(COUNTERS), False]
    _open.append(span)
    return span


def phase(name: str) -> None:
    """Start phase ``name`` of the innermost open span, ending its open
    phase; no-op when that phase is already ``name`` or no span is open."""
    global _ids
    if not _open or (_open[-1][5] and _open[-1][0] == name):
        return
    now = time.perf_counter_ns()
    if _open[-1][5]:
        _close_to(len(_open) - 1, now)
    _ids += 1
    _open.append([name, _ids, _open[-1][1], now, None, True])


def end(span: list) -> None:
    """Close ``span`` and whatever is still open inside it."""
    for depth in range(len(_open) - 1, -1, -1):
        if _open[depth] is span:
            _close_to(depth, time.perf_counter_ns())
            return


def current_chunk() -> int:
    """The span id of the innermost open ``chunk`` span, 0 if none."""
    for span in reversed(_open):
        if span[0] == "chunk":
            return span[1]
    return 0


def sample_chunk(device) -> int:
    """Count one chunk launcher call on ``device``: the address of a zeroed
    row for the call's phase totals when the call is sampled, else 0.  The
    first call after ``enable()`` allocates the buffer."""
    global _calls
    _calls += 1
    block = _blocks[-1] if _blocks else None
    if block is None or block[2] != device or block[1] == ROWS_PER_BLOCK:
        import torch

        block = [torch.zeros((ROWS_PER_BLOCK, len(PHASES)), dtype=torch.int64,
                             device=device), 0, device]
        _blocks.append(block)
    if _calls % SAMPLE_EVERY:
        return 0
    row = block[1]
    block[1] += 1
    _rows.append((block[0], row, current_chunk()))
    return block[0].data_ptr() + row * len(PHASES) * block[0].element_size()


def phase_rows() -> list:
    """``PhaseRow`` of every sampled call, oldest first, copied to the host
    (waits for the card)."""
    host = {}
    out = []
    for block, row, span_id in _rows:
        key = id(block)
        if key not in host:
            host[key] = block.cpu().tolist()
        out.append(PhaseRow(span_id, dict(zip(PHASES, host[key][row]))))
    return out

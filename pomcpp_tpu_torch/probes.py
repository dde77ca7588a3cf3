"""Micro-probes of the kernels' op patterns on the card.

Counterparts of the Pallas probes in ``scripts/microbench_sublane.py``,
``microbench_i16.py``, ``microbench_layout.py``, ``microbench_patterns.py``
and ``microbench_reductions.py``: each probe runs ``k`` loop iterations of
one op pattern over an array of 128-lane rows (one row = one board's
121-cell plane plus pad lanes) and, for the agent patterns, over a
``[rows, 4]`` agent array, and returns the same arrays as the Pallas body
does on the same input, bit for bit.

Four kernel families (``csrc/probes.cu``), each an entry point here with a
plain PyTorch version beside it:

* ``probe_elem``   -- elementwise chains: ``elem`` (sublane / layout),
  ``chain`` (i32 / i16 / i8), ``baseline``, ``cond_false``, ``cond_true``,
  ``while_2it``;
* ``probe_shift``  -- lane rolls and agent rotations: ``roll``, ``roll2``
  (i32 / i16 / i8), ``push``, ``push_hoist``, ``prefix_or``, ``whole4``,
  ``rot4_all``, ``colslice``;
* ``probe_reduce`` -- reductions: ``sumred``, ``axis1_any``, ``packed_sum``,
  ``min_red4``, ``onehot_rd`` per row, ``any_plane`` and ``any4`` over each
  tile of 128 rows;
* ``probe_dot``    -- f32 products computed in the kernel: ``dot`` (the
  chain of [R, 128] x [128, 128] products, on the tensor cores in
  ``probe_dot_tc_kernel``: TF32 pieces, three passes, f32 accumulation) and
  ``dotred`` (one-column products inside row reductions,
  ``probe_dot_kernel``).

``layout`` picks how the work maps onto threads; both give the same
output.  ``"cta"`` is one row per 128-thread CTA, one cell per thread,
exchange through shared memory and ``__syncthreads`` (the engine kernels'
first layout, kept as an instrument), in every family.  ``"warp"`` is the
design for the card, per family (``csrc/probe_warp.cuh`` for elem and
shift):

* elem   -- a dense element mapping: the ``[R, width]`` array flattened,
  four consecutive elements a thread (one 16-byte access for i32), so the
  cost follows R x width and not R x 128 lanes;
* shift  -- plane rolls one row per warp, cells 4t..4t+3 in lane t (the
  engine's layout), a shuffle only for a value whose source lies in another
  lane's four cells (``roll`` by 1: one a lane; by 117: four);
  ``prefix_or`` a warp scan of five ``__shfl_up_sync`` rounds; the agent
  patterns (``whole4``, ``rot4_all``, ``colslice``) 32 rows a warp, a row's
  four agents in one lane's registers, no shuffle;
* reduce   -- ``sumred`` and ``min_red4`` one row per warp, four cells a
  lane, a row's sum or minimum one ``redux.sync`` (``__reduce_add_sync``,
  ``__reduce_min_sync``) and no shuffle, the row's agents in every lane's
  registers; ``axis1_any`` 32 rows a warp, a row's agents in one lane;
  ``any4`` one warp a tile, 16 agent values a lane, one ``__any_sync`` an
  iteration; ``onehot_rd`` and ``packed_sum`` as the lookups they are (a
  one-hot max or packed sum over the row reads one cell an agent): 32 rows
  a warp, the rows' planes in the warp's shared memory, one load a lookup;
  ``any_plane`` keeps the CTA's tile kernel (a warp vote, then the CTA);
* ``dotred`` -- a row over 8 lanes, 16 cells a lane, the 16-bit halves made
  floats by a byte permute (low half) or a shift-and-add (high half) and an
  FADD (no int -> float conversion), 16 FFMAs a half in the lane and three
  ``__shfl_xor_sync`` rounds across the 8.

``dot`` takes no layout: a warpgroup of its kernel owns 64 rows.
``rows`` / ``tile`` restrict the work to the first ``rows`` rows of every
``tile`` rows, the sublane script's sweep; the other rows are copied.

On a CUDA tensor an entry point launches its kernel and adds one to
``_ext.LAUNCHES``; on a CPU tensor it runs the plain version (integer
tensor ops in a Python loop over ``k``).  There is no fallback between the
two.  ``device=None`` means the card.

    python -m pomcpp_tpu_torch.probes [sublane|i16|layout|patterns|reductions ...]

times every pattern of the named scripts (all by default) in both layouts
at the scripts' sizes (16384 rows, K = 200 or 300) and prints one line per
pattern and layout with its bound, after a first line with the card's name,
power limit and rates (``card_rates``).

A pattern's bound is the least time the card could take for its function:
the largest of its 32-bit instructions over the issue rate (128 lanes a
clock per SM: four schedulers, one warp instruction a clock each), its lane
shuffles over the shuffle rate (32 lanes a clock per SM) and its bytes
(every input read once, every output written once) over the memory rate;
``dot`` counts its tensor-core passes instead of instructions.  The counts
(``Pattern.ops``, ``Pattern.shuffles``) are the fewest the function needs,
op by op: a compare, a select with a constant arm, a three-input add
(IADD3) or a three-input logic op (LOP3) is one instruction, a roll's move
within a lane is none, a value that crosses a lane's four cells (the
engine's row layout) is one shuffle, and every shuffle also takes an issue
slot.  A reduction of n values is its in-lane combines ((n - 1) / 2 IADD3
for a sum; an FFMA is a product and its accumulation) and has no shuffle
term, since a row could be reduced inside one lane; a lookup of one cell
at a known position is one load.  Every iteration keeps its own reduction,
as the Pallas body runs it: no closed form across rounds or iterations.  No
identity across ops is used but those nvcc is seen to use (in the SASS) or
a kernel here uses: a roll's adds of i between two lane crossings of a
value fold into one; the loops of the i8 ``chain``, ``cond_*`` and
``while_2it`` fold to a closed form, counted once per element whatever K;
``min_red4``'s first set cell, in cell order, is its minimum, so a select a
cell is its reduction.
"""

from __future__ import annotations

import subprocess
import sys
from typing import NamedTuple

import torch

from . import _ext
from .core.state import I32
from .device import (Rates, card_rates, method_floor, rates_line, resolve_device,
                     time_device)

LANES = 128
AGENTS = 4
TILE = 128
LAYOUTS = {"cta": 0, "warp": 1}

ELEM_OPS = {"elem": 0, "chain": 1, "baseline": 2, "cond_false": 3,
            "cond_true": 4, "while_2it": 5}
SHIFT_OPS = {"roll": 0, "roll2": 1, "push": 2, "push_hoist": 3, "prefix_or": 4,
             "whole4": 5, "rot4_all": 6, "colslice": 7}
REDUCE_OPS = {"sumred": 0, "axis1_any": 1, "packed_sum": 2, "min_red4": 3,
              "onehot_rd": 4, "any_plane": 5, "any4": 6}
DOT_OPS = {"dot": 0, "dotred": 1}
NARROW_OK = {"chain", "roll2"}       # ops that also exist for i16 and i8
TILE_OPS = {"any_plane", "any4"}     # reduce over a whole 128-row tile
INT_TYPES = (torch.int32, torch.int16, torch.int8)


# --- Plain versions ---------------------------------------------------------------


def _on_live_rows(x, rows: int, tile: int, fn):
    """``fn`` applied to the first ``rows`` rows of every ``tile`` rows."""
    if rows >= tile:
        return fn(x)
    if x.shape[0] % tile:
        raise ValueError(f"{x.shape[0]} rows do not divide into tiles of {tile}")
    out = x.clone().view(-1, tile, x.shape[1])
    # A copy: an op that leaves the array alone returns its input, which
    # may be a view of ``out`` (one tile).
    live = out[:, :rows].reshape(-1, x.shape[1]).clone()
    out[:, :rows] = fn(live).view(-1, rows, x.shape[1])
    return out.view(x.shape)


def _chain_masks(dtype):
    bits = torch.iinfo(dtype).bits
    return 0x7E7E & ((1 << (bits - 1)) - 1), 0x0101 & ((1 << (bits - 1)) - 1)


def probe_elem_plain(x, op: str, k: int, rows: int = TILE, tile: int = TILE):
    """Plain version of ``probe_elem``: ``x`` is ``[R, width]``."""
    def run(x):
        for i in range(k):
            if op == "elem":
                for _ in range(16):
                    x = torch.where(x > 3, x - 3, x + 1)
                    x = (x ^ 5) + i
            elif op == "chain":
                keep, carry = _chain_masks(x.dtype)
                for _ in range(8):
                    x = (x & keep) | ((x + 1) & carry)
                    x = x ^ (x >> 7)
            elif op == "baseline":
                for _ in range(8):
                    x = torch.where(x > 3, x - 3, x + 1) ^ i
            elif op == "cond_false":
                pass
            elif op == "cond_true":
                x = x + 1
            elif op == "while_2it":
                for _ in range(2):
                    x = x + 1
            else:
                raise ValueError(f"unknown elem op {op!r}")
        return x

    return _on_live_rows(x, rows, tile, run)


def _push_masks(device):
    lane = torch.arange(LANES, dtype=I32, device=device)
    ok_down = (lane // 11 + 1 < 11) & (lane < 121)
    ok_right = (lane % 11 - 1 >= 0) & (lane < 121)
    return lane, ok_down, ok_right


def probe_shift_plain(plane, agents, op: str, k: int, rows: int = TILE,
                      tile: int = TILE):
    """Plain version of ``probe_shift``: ``plane`` ``[R, 128]``, ``agents``
    ``[R, 4]`` or None."""
    lane, ok_down, ok_right = _push_masks(plane.device)

    def roll(x, s):
        return torch.roll(x, s, 1)

    def run_plane(p):
        for i in range(k):
            if op == "roll":
                for _ in range(32):
                    p = roll(p, 1) + i
            elif op == "roll2":
                for _ in range(4):
                    p = p + roll(p, 1)
                    p = p ^ roll(p, 117)
            elif op in ("push", "push_hoist"):
                p = torch.where(ok_down, roll(p, 117), 0) \
                    + torch.where(ok_right, roll(p, 1), 0) + i
            elif op == "prefix_or":
                q = p
                for sh in (1, 2, 4, 8, 16, 32, 64):
                    q = q | torch.where(lane >= sh, roll(q, sh), 0)
                p = p ^ q
        return p.to(plane.dtype)

    def run_agents(a):
        for i in range(k):
            if op == "whole4":
                a = torch.where(a == roll(a, -1), a + 1, a - 1) ^ i
                a = torch.maximum(a, roll(a, -2)) + i
            elif op == "rot4_all":
                t = (a & 7) != 7
                allm = t & roll(t, -1) & roll(t, -2) & roll(t, -3)
                a = a + torch.where(allm, 1, 2)
            elif op == "colslice":
                for j in range(AGENTS):
                    c = a[:, j]
                    a = a.clone()
                    a[:, j] = torch.where(c > 2, c - 2, c + 1) ^ i
        return a.to(I32)

    if op not in SHIFT_OPS:
        raise ValueError(f"unknown shift op {op!r}")
    plane_out = _on_live_rows(plane, rows, tile, run_plane)
    if agents is None:
        return plane_out
    return plane_out, _on_live_rows(agents, rows, tile, run_agents)


def probe_reduce_plain(plane, agents, op: str, k: int, rows: int = TILE,
                       tile: int = TILE):
    """Plain version of ``probe_reduce``."""
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    dev = plane.device
    lane = torch.arange(LANES, dtype=I32, device=dev)
    lane4 = torch.arange(AGENTS, dtype=I32, device=dev)
    if op == "sumred":
        def run(p):
            for _ in range(k * 8):
                p = p + p.sum(1, keepdim=True).to(I32)
            return p

        out = _on_live_rows(plane, rows, tile, run)
        return out if agents is None else (out, agents.clone())
    if op in TILE_OPS:
        if plane.shape[0] % TILE:
            raise ValueError("tile reductions need whole tiles of 128 rows")
        p = plane.view(-1, TILE, LANES)
        a = agents.view(-1, TILE, AGENTS)
        for _ in range(k):
            if op == "any_plane":
                hit = ((p & 7) == 7).flatten(1).any(1)[:, None, None]
                p = p + torch.where(hit, 1, 2)
            else:
                hit = ((a & 7) == 7).flatten(1).any(1)[:, None, None]
                a = a + torch.where(hit, 1, 2)
        return p.reshape(plane.shape).to(I32), a.reshape(agents.shape).to(I32)

    # The row ops read the plane and update the agents; every row is live
    # or not as a whole, so the two arrays are cut alike.
    def run(pa):
        p, a = pa[:, :LANES], pa[:, LANES:]
        for _ in range(k):
            if op == "axis1_any":
                m = ((a & 7) == 7).any(1, keepdim=True)
                a = a + torch.where(m, 1, 2)
            elif op == "packed_sum":
                w = torch.zeros_like(p)
                for j in range(AGENTS):
                    w = w + ((lane == (a[:, j:j + 1] & 127)).to(I32) << (5 * j))
                red = ((p & 15) * w).sum(1, keepdim=True).to(I32)
                a = a + ((red >> (5 * lane4)) & 31)
            elif op == "min_red4":
                for j in range(AGENTS):
                    m = (p & (1 << j)) != 0
                    v = torch.where(m, lane, 999).min(1, keepdim=True).values
                    a = a + (v & (1 << j))
            elif op == "onehot_rd":
                for j in range(AGENTS):
                    oh = lane == a[:, j:j + 1]
                    v = torch.where(oh, p, 0).max(1, keepdim=True).values
                    a = torch.where(lane4 == j, v & 0xFF, a)
        return torch.cat([p, a.to(I32)], 1)

    out = _on_live_rows(torch.cat([plane, agents], 1), rows, tile, run)
    return out[:, :LANES].contiguous(), out[:, LANES:].contiguous()


def probe_dot_plain(x, w, op: str, k: int, rows: int = TILE, tile: int = TILE):
    """Plain version of ``probe_dot``: ``x`` f32 (``dot``) or i32
    (``dotred``) ``[R, 128]``, ``w`` f32 ``[128, 128]``."""
    def run(x):
        if op == "dot":
            for _ in range(k * 32):
                x = x @ w + 1.0
        elif op == "dotred":
            ones = w[:, :8]
            for _ in range(k * 8):
                lo = (x & 0xFFFF).to(torch.float32) @ ones
                hi = (x >> 16).to(torch.float32) @ ones
                x = x + (lo[:, :1].to(I32) + (hi[:, :1].to(I32) << 16))
        else:
            raise ValueError(f"unknown dot op {op!r}")
        return x

    return _on_live_rows(x, rows, tile, run)


# --- Kernel wrappers --------------------------------------------------------------


def _ready(t, dtype, shape, what, device_type):
    t = t.contiguous()
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {dtype} {list(shape)}")
    if t.device.type != device_type:
        raise ValueError(f"{what} is not on a {device_type} device")
    return t


def _launch_args(layout, k, rows, tile):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {sorted(LAYOUTS)}")
    if k < 0 or rows < 0 or tile < 1:
        raise ValueError("k and rows must be >= 0 and tile >= 1")
    return LAYOUTS[layout]


def _int_type(t, op):
    if t.dtype not in INT_TYPES or (t.dtype != I32 and op not in NARROW_OK):
        raise ValueError(f"op {op!r} does not take {t.dtype}")
    return t.element_size()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _probe_elem_launch(lib, stream, x, op, k, layout, rows, tile):
    """Marshal the arguments and call the elem launcher of ``lib``: the
    ``nvcc`` build on the card's stream, which counts as a launch, or, in
    the tests, the host build of ``csrc/probe_warp.cuh`` on CPU tensors
    (``stream=None``), which does not."""
    lay = _launch_args(layout, k, rows, tile)
    size = _int_type(x, op)
    if x.dim() != 2 or not 1 <= x.shape[1] <= LANES:
        raise ValueError("x must be [rows, width] with width <= 128")
    x = _ready(x, x.dtype, tuple(x.shape), "x",
               "cpu" if stream is None else "cuda")
    out = torch.empty_like(x)
    _ext.check(lib.pomcpp_probe_elem(
        ELEM_OPS[op], lay, size, x.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], k, rows, tile, stream), lib.pomcpp_probes_error_string)
    if stream is not None:
        _ext.LAUNCHES["probe_elem_kernel"] += 1
    return out


def _probe_elem_cuda(x, op, k, layout, rows, tile):
    return _probe_elem_launch(_ext.probes_lib(), _stream(), x, op, k, layout,
                              rows, tile)


def _plane_and_agents(plane, agents, dtype, device_type):
    n = plane.shape[0]
    plane = _ready(plane, dtype, (n, LANES), "plane", device_type)
    if agents is None:
        return plane, None, None, n
    agents = _ready(agents, I32, (n, AGENTS), "agents", device_type)
    return plane, agents, torch.empty_like(agents), n


def _probe_shift_launch(lib, stream, plane, agents, op, k, layout, rows,
                        tile):
    """As ``_probe_elem_launch``, for the shift family."""
    lay = _launch_args(layout, k, rows, tile)
    size = _int_type(plane, op)
    plane, agents, a_out, n = _plane_and_agents(
        plane, agents, plane.dtype, "cpu" if stream is None else "cuda")
    p_out = torch.empty_like(plane)
    _ext.check(lib.pomcpp_probe_shift(
        SHIFT_OPS[op], lay, size, plane.data_ptr(), p_out.data_ptr(),
        None if agents is None else agents.data_ptr(),
        None if agents is None else a_out.data_ptr(), n, k, rows, tile,
        stream), lib.pomcpp_probes_error_string)
    if stream is not None:
        _ext.LAUNCHES["probe_shift_kernel"] += 1
    return p_out if agents is None else (p_out, a_out)


def _probe_shift_cuda(plane, agents, op, k, layout, rows, tile):
    return _probe_shift_launch(_ext.probes_lib(), _stream(), plane, agents,
                               op, k, layout, rows, tile)


def _probe_reduce_launch(lib, stream, plane, agents, op, k, layout, rows,
                         tile):
    """As ``_probe_elem_launch``, for the reduce family."""
    lay = _launch_args(layout, k, rows, tile)
    plane, agents, a_out, n = _plane_and_agents(
        plane, agents, I32, "cpu" if stream is None else "cuda")
    p_out = torch.empty_like(plane)
    _ext.check(lib.pomcpp_probe_reduce(
        REDUCE_OPS[op], lay, plane.data_ptr(), p_out.data_ptr(),
        None if agents is None else agents.data_ptr(),
        None if agents is None else a_out.data_ptr(), n, k, rows, tile,
        stream), lib.pomcpp_probes_error_string)
    if stream is not None:
        _ext.LAUNCHES["probe_reduce_kernel"] += 1
    return p_out if agents is None else (p_out, a_out)


def _probe_reduce_cuda(plane, agents, op, k, layout, rows, tile):
    return _probe_reduce_launch(_ext.probes_lib(), _stream(), plane, agents,
                                op, k, layout, rows, tile)


def _probe_dot_launch(lib, stream, x, w, op, k, layout, rows, tile):
    """As ``_probe_elem_launch``, for the dot family."""
    lay = _launch_args(layout, k, rows, tile)
    n = x.shape[0]
    device_type = "cpu" if stream is None else "cuda"
    x = _ready(x, torch.float32 if op == "dot" else I32, (n, LANES), "x",
               device_type)
    w = _ready(w, torch.float32, (LANES, LANES), "w", device_type)
    out = torch.empty_like(x)
    _ext.check(lib.pomcpp_probe_dot(
        DOT_OPS[op], lay, x.data_ptr(), w.data_ptr(), out.data_ptr(), n, k,
        rows, tile, stream), lib.pomcpp_probes_error_string)
    if stream is not None:
        _ext.LAUNCHES[DOT_KERNEL[op]] += 1
    return out


def _probe_dot_cuda(x, w, op, k, layout, rows, tile):
    return _probe_dot_launch(_ext.probes_lib(), _stream(), x, w, op, k,
                             layout, rows, tile)


def _place(device, *tensors):
    device = resolve_device(device)
    return device, [None if t is None else torch.as_tensor(t).to(device)
                    for t in tensors]


def _known(op, table):
    if op not in table:
        raise ValueError(f"unknown op {op!r}; one of {sorted(table)}")


def probe_elem(x, op: str, k: int, layout: str = "cta", rows: int = TILE,
               tile: int = TILE, device=None):
    """``k`` iterations of an elementwise chain over ``x`` ``[R, width]``
    (width <= 128; i32, or i16 / i8 for ``chain``)."""
    _known(op, ELEM_OPS)
    device, (x,) = _place(device, x)
    if device.type == "cpu":
        return probe_elem_plain(x, op, k, rows, tile)
    return _probe_elem_cuda(x, op, k, layout, rows, tile)


def probe_shift(plane, agents, op: str, k: int, layout: str = "cta",
                rows: int = TILE, tile: int = TILE, device=None):
    """``k`` iterations of a neighbour-exchange pattern.  ``plane`` is
    ``[R, 128]`` (i32, or i16 / i8 for ``roll2``), ``agents`` i32 ``[R, 4]``
    or None; returns the new plane, or ``(plane, agents)``."""
    _known(op, SHIFT_OPS)
    if agents is None and op in ("whole4", "rot4_all", "colslice"):
        raise ValueError(f"{op} needs the agent array")
    device, (plane, agents) = _place(device, plane, agents)
    if device.type == "cpu":
        return probe_shift_plain(plane, agents, op, k, rows, tile)
    return _probe_shift_cuda(plane, agents, op, k, layout, rows, tile)


def probe_reduce(plane, agents, op: str, k: int, layout: str = "cta",
                 rows: int = TILE, tile: int = TILE, device=None):
    """``k`` iterations of a reduction pattern over ``plane`` i32
    ``[R, 128]`` and ``agents`` i32 ``[R, 4]`` (None only for ``sumred``);
    returns ``(plane, agents)``, or the plane alone without agents."""
    _known(op, REDUCE_OPS)
    if op in TILE_OPS and (rows < tile or tile != TILE):
        raise ValueError(f"{op} reduces over whole tiles of {TILE} rows")
    if agents is None and op != "sumred":
        raise ValueError(f"{op} needs the agent array")
    device, (plane, agents) = _place(device, plane, agents)
    if device.type == "cpu":
        return probe_reduce_plain(plane, agents, op, k, rows, tile)
    return _probe_reduce_cuda(plane, agents, op, k, layout, rows, tile)


def probe_dot(x, w, op: str, k: int, layout: str = "cta", rows: int = TILE,
              tile: int = TILE, device=None):
    """``k`` iterations of chained products with ``w`` f32 ``[128, 128]``:
    ``dot`` on ``x`` f32 ``[R, 128]`` (32 products + 1.0 per iteration; on
    the card from TF32 pieces, exact wherever every value is an integer
    below 2^13, else within 2^-15 of ``|x| @ |w|`` a product),
    ``dotred`` on ``x`` i32 ``[R, 128]`` (8 row sums by two 16-bit-half
    products per iteration)."""
    _known(op, DOT_OPS)
    device, (x, w) = _place(device, x, w)
    if device.type == "cpu":
        return probe_dot_plain(x, w, op, k, rows, tile)
    return _probe_dot_cuda(x, w, op, k, layout, rows, tile)


# --- The scripts' patterns ---------------------------------------------------------


class Pattern(NamedTuple):
    script: str      # scripts/microbench_<script>.py
    name: str        # the script's own name of the pattern
    family: str      # elem | shift | reduce | dot
    op: str
    k: int           # the script's loop count
    per_iter: int    # what the script divides by: chained ops, reductions
                     # or products per iteration (1: it reports per iteration)
    ops: float       # 32-bit instructions per element and iteration besides
                     # the shuffles (the module docstring's counting rule)
    dtype: torch.dtype = I32
    width: int = LANES
    shuffles: float = 0.0   # lane shuffles per element and iteration
    closed: bool = False    # ``ops`` is per element for the whole launch:
                            # the loop folds to a closed form

    @property
    def on_agents(self) -> bool:
        """The pattern works on the [R, 4] agent array, not on the plane."""
        return self.op in ("colslice", "whole4", "rot4_all", "any4",
                           "axis1_any")


def _patterns():
    # Per element and iteration; "lane" counts are per 4 cells.
    out = [
        # 16 rounds of x > 3 (ISETP), -4 or 0 (SEL), x + 1 + sel (IADD3),
        # ^ 5 (LOP3), + i: the compare needs x after its add (comparing
        # before it would differ where the add wraps).
        Pattern("sublane", "elem", "elem", "elem", 200, 64, 80),
        # 32 x (roll by 1: 1 shuffle a lane; + i).  A value crosses a lane
        # every 4 rolls and its adds of i in between fold into one (nvcc
        # does): 8 adds and 8 shuffles an element.
        Pattern("sublane", "roll", "shift", "roll", 200, 64, 8,
                shuffles=32 / 4),
        # dot: 32 x (128 FMAs + 1 add) per element and iteration outside the
        # tensor cores (its bound is the tensor-core passes, ``tensor_ops``).
        Pattern("sublane", "dot", "dot", "dot", 200, 32, 32 * 129,
                torch.float32),
        # sumred: 8 rounds of the row sum (127 adds of 128 cells, 64 IADD3:
        # half an instruction an element) and its add back into every cell.
        Pattern("sublane", "sumred", "reduce", "sumred", 200, 8,
                8 * (64 / 128 + 1)),
        # dotred, per element and round: each 16-bit half made a float by
        # one instruction (lo: a byte permute under 0x4B00; hi: (x >> 16) +
        # 0x4B400000, a shift-and-add) and an FADD; an FFMA a half into the
        # column the script reads (the product and the sum's combine); the
        # add of r.  Per row and round: the two truncating casts and lo +
        # (hi << 16).
        Pattern("sublane", "dotred", "dot", "dotred", 200, 8,
                8 * (7 + 3 / 128)),
    ]
    for dtype in INT_TYPES:
        if dtype == torch.int8:
            # After one round bit 7 is clear, x >> 7 is 0 and a round only
            # toggles bit 0, 8 times an iteration: the chain is x & 0x7F.
            out.append(Pattern("i16", "chain", "elem", "chain", 300, 1, 1,
                               dtype, closed=True))
        else:
            # 8 rounds of x + 1 (IADD3), & carry, (x & keep) | u (two LOP3),
            # x >> 7 (SHF), ^ (LOP3).
            out.append(Pattern("i16", "chain", "elem", "chain", 300, 1, 40,
                               dtype))
        # 4 x (roll by 1: 1 shuffle a lane; +, and for i16 / i8 its wrap to
        # the type; roll by 117: 4; ^).
        out.append(Pattern("i16", "roll", "shift", "roll2", 300, 1,
                           8 if dtype == I32 else 12, dtype,
                           shuffles=4 * 5 / 4))
    for width in (128, 4, 8, 32):
        out.append(Pattern("layout", "elem", "elem", "elem", 200, 64, 80,
                           width=width))
    # 8 rounds of x > 3 (ISETP), -4 or 0 (SEL), x + 1 + sel (IADD3), ^ i.
    out.append(Pattern("patterns", "baseline", "elem", "baseline", 300, 1,
                       32))
    # colslice: per agent, > 2, -3 or 0, + 1 + sel, ^ i.  whole4: ==, +2 or
    # 0, - 1 + sel, ^ i, max, + i; the rolls are register moves.
    # push / push_hoist: the two masked arms (constant masks, hoisted) and
    # one IADD3; roll by 117 (4 shuffles a lane) and by 1 (1).
    for name, ops, shuffles in (("colslice", 4, 0), ("whole4", 6, 0),
                                ("push", 3, 5 / 4), ("push_hoist", 3, 5 / 4)):
        out.append(Pattern("patterns", name, "shift", name, 300, 1, ops,
                           shuffles=shuffles))
    # onehot_rd: a lookup an agent (a one-hot max over the row is one cell):
    # the range compare, the load, the max with 0, the select of 0 off the
    # row, & 0xFF: 20 a row of 128 cells.
    out.append(Pattern("patterns", "onehot_rd", "reduce", "onehot_rd", 300, 1,
                       20 / 128))
    out.append(Pattern("reductions", "baseline", "elem", "baseline", 300, 1,
                       32))
    # any_plane: (p & 7) == 7, the OR, the select, the add.
    # any4, per agent value: the test, the add, and a tile's OR of 512
    # flags (256 LOP3) and select.  axis1_any, per row of four agents: as
    # rot4_all.  packed_sum: a lookup an agent (field j of the packed sum is
    # p[a_j & 127] & 15): & 127, the load, & 15, the add: 16 a row.
    # min_red4, per cell and agent: the bit's test and the select of the
    # cell's index, a select chain in cell order being the minimum; per
    # row, the four masked minima (4), their OR (2) and four adds.
    for name, ops in (("any_plane", 4), ("any4", 2 + 257 / 512),
                      ("axis1_any", 11 / 4), ("packed_sum", 16 / 128),
                      ("min_red4", 4 * 2 + 10 / 128)):
        out.append(Pattern("reductions", name, "reduce", name, 300, 1, ops))
    # rot4_all: a row's (a & 7) != 7 (4 LOP3 with a predicate out), their
    # AND (2), 1 or 2 (1), four adds: 11 a row of four agents.
    out.append(Pattern("reductions", "rot4_all", "shift", "rot4_all", 300, 1,
                       11 / 4))
    # Closed forms: nothing, x + K, x + 2K.
    for name, ops in (("cond_false", 0), ("cond_true", 1), ("while_2it", 1)):
        out.append(Pattern("reductions", name, "elem", name, 300, 1, ops,
                           closed=True))
    # prefix_or as a warp scan, a lane's 4 cells: their OR (2), 5 shuffle
    # rounds of the lane totals (an OR each into the inclusive and, guarded,
    # the exclusive total; the last round the exclusive only: 9), then per
    # cell q & ~p and the running q | p (7).
    out.append(Pattern("reductions", "prefix_or", "shift", "prefix_or", 300,
                       1, 18 / 4, shuffles=5 / 4))
    return tuple(out)


PATTERNS = _patterns()
SCRIPTS = ("sublane", "i16", "layout", "patterns", "reductions")
FAMILY_KERNEL = {"elem": "probe_elem_kernel", "shift": "probe_shift_kernel",
                 "reduce": "probe_reduce_kernel", "dot": "probe_dot_kernel"}
DOT_KERNEL = {"dot": "probe_dot_tc_kernel", "dotred": "probe_dot_kernel"}
TC_PASSES = 3     # TF32 products per f32 product in probe_dot_tc_kernel


# The closed forms of the patterns whose loops fold (``Pattern.closed``),
# each one PyTorch call: what their counts rest on, held against the plain
# versions by the tests and on the card.
CLOSED_FORMS = {
    "chain": lambda x, k: x & 0x7F if k else x.clone(),   # int8 only
    "cond_false": lambda x, k: x.clone(),
    "cond_true": lambda x, k: x + k,
    "while_2it": lambda x, k: x + 2 * k,
}


def kernel_of(p: Pattern) -> str:
    """The kernel that runs pattern ``p`` (its launch count's key)."""
    return DOT_KERNEL[p.op] if p.family == "dot" else FAMILY_KERNEL[p.family]


def tensor_ops(p: Pattern, n_rows: int, k=None) -> int:
    """Tensor-core operations that ``probe_dot_tc_kernel`` issues for the
    ``dot`` pattern: ``TC_PASSES`` products of 2 x 128 operations per
    output element, 32 a loop iteration."""
    k = p.k if k is None else k
    return n_rows * LANES * k * 32 * 2 * LANES * TC_PASSES


def work(p: Pattern, n_rows: int, k=None) -> tuple[float, float, int]:
    """(instructions, lane shuffles, bytes) of one launch: ``ops`` and
    ``shuffles`` per element of the array the pattern works on and
    iteration (instructions include the shuffles, which take an issue slot
    too); every input read once and every output written once."""
    k = p.k if k is None else k
    elements = n_rows * (AGENTS if p.on_agents else p.width)
    size = torch.empty((), dtype=p.dtype).element_size()
    moved = 2 * n_rows * p.width * size
    if p.family == "dot":
        moved += LANES * LANES * 4
    elif p.script in ("patterns", "reductions") and p.family != "elem":
        moved += 2 * n_rows * AGENTS * 4
    shuffles = elements * k * p.shuffles
    ops = elements * (1 if p.closed else k) * p.ops
    return ops + shuffles, shuffles, moved


def bound(p: Pattern, n_rows: int, rates: Rates, k=None) -> tuple[float, str]:
    """(ms, term): the least time of one launch, the largest of its
    instructions over the issue rate ("instructions"; ``dot``: its
    tensor-core operations over the TF32 rate, "tensor"), its lane shuffles
    over the shuffle rate ("shuffles") and its bytes over the memory rate
    ("bytes")."""
    instructions, shuffles, moved = work(p, n_rows, k)
    ops = (instructions / rates.issue, "instructions")
    if p.op == "dot":
        ops = (tensor_ops(p, n_rows, k) / rates.tf32, "tensor")
    t, term = max(ops, (shuffles / rates.shuffle, "shuffles"),
                  (moved / rates.hbm, "bytes"), key=lambda x: x[0])
    return t * 1e3, term


def label(p: Pattern) -> str:
    extra = ""
    if p.script == "i16":
        extra = f"[{str(p.dtype).split('.')[-1]}]"
    elif p.script == "layout":
        extra = f"[128x{p.width}]"
    return f"{p.script}.{p.name}{extra}"


def pattern_inputs(p: Pattern, n_rows: int, device, seed=None):
    """Input tensors of a pattern on ``device``: the scripts' constant
    arrays (ones; agents 2; a shift matrix or ones for ``w``) when ``seed``
    is None, else seeded random values that keep the f32 products exact."""
    device = resolve_device(device)
    gen = None if seed is None else torch.Generator().manual_seed(seed)

    def ints(shape, lo, hi, dtype=I32, fill=1):
        if gen is None:
            return torch.full(shape, fill, dtype=dtype)
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int64).to(dtype)

    if p.family == "dot":
        if p.op == "dot":
            x = ints((n_rows, LANES), 0, 4).to(torch.float32)
            w = torch.diag(torch.ones(LANES - 1), 1)        # shift matrix
        else:
            x = ints((n_rows, LANES), -2 ** 31, 2 ** 31)
            w = torch.ones((LANES, LANES))
        return {"x": x.to(device), "w": w.to(device)}
    if p.family == "elem":
        info = torch.iinfo(p.dtype)
        lo, hi = (info.min, info.max) if p.op == "chain" else (-50, 50)
        return {"x": ints((n_rows, p.width), lo, hi, p.dtype).to(device)}
    info = torch.iinfo(p.dtype)
    lo, hi = (info.min, info.max + 1) if p.dtype != I32 else (-2 ** 15, 2 ** 15)
    plane = ints((n_rows, LANES), lo, hi, p.dtype).to(device)
    if p.script in ("sublane", "i16"):
        return {"plane": plane, "agents": None}
    agents = ints((n_rows, AGENTS), -3, 131, fill=2).to(device)
    return {"plane": plane, "agents": agents}


def run_pattern(p: Pattern, inputs, k=None, layout: str = "cta",
                plain: bool = False, rows: int = TILE, tile: int = TILE):
    """Run pattern ``p`` on ``inputs`` (``pattern_inputs``): the entry
    point on the inputs' device, or the plain version there."""
    k = p.k if k is None else k
    if p.family == "elem":
        x = inputs["x"]
        if plain:
            return probe_elem_plain(x, p.op, k, rows, tile)
        return probe_elem(x, p.op, k, layout, rows, tile, device=x.device)
    if p.family == "dot":
        x, w = inputs["x"], inputs["w"]
        if plain:
            return probe_dot_plain(x, w, p.op, k, rows, tile)
        return probe_dot(x, w, p.op, k, layout, rows, tile, device=x.device)
    fn_plain, fn = (probe_shift_plain, probe_shift) if p.family == "shift" \
        else (probe_reduce_plain, probe_reduce)
    plane, agents = inputs["plane"], inputs["agents"]
    if plain:
        return fn_plain(plane, agents, p.op, k, rows, tile)
    return fn(plane, agents, p.op, k, layout, rows, tile, device=plane.device)


def time_pattern(p: Pattern, inputs, layout: str, reps: int = 3) -> float:
    """Mean device milliseconds of one launch at the pattern's own ``k``
    (``time_device``)."""
    device = next(t for t in inputs.values() if t is not None).device
    return time_device(lambda: run_pattern(p, inputs, layout=layout), device,
                       reps)


def report_line(p: Pattern, layout: str, ms: float, bound_ms=None,
                term=None) -> str:
    unit = "op" if p.per_iter > 1 else "iter"
    ns = ms * 1e6 / (p.k * p.per_iter)
    line = (f"{label(p):28s} {layout:4s}: {ms:9.4f} ms  "
            f"{ns:9.1f} ns/{unit} (K={p.k}, {p.per_iter} per iteration)")
    if bound_ms is not None:
        line += f"; bound {bound_ms:.4f} ms ({term}), {bound_ms / ms:.0%}"
    return line


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def floor_line(floor: dict) -> str:
    return (f"timer floor (time_device): empty kernel {floor['empty_ms']:.4f} "
            f"ms, 16 MB copy {floor['copy_16mb_ms']:.4f} ms")


def run_report(scripts=SCRIPTS, n_rows: int = 16384, reps: int = 3,
               device=None, out=print):
    """Time every pattern of ``scripts`` in both layouts at the scripts'
    own sizes; writes one line per pattern and layout, with the pattern's
    bound, through ``out`` and returns ``[(pattern, layout, ms), ...]``."""
    device = resolve_device(device)
    rates = card_rates(device.index or 0)
    out(f"device: {card_line()}; {n_rows} rows x {LANES} lanes; "
        f"{rates_line(rates)}")
    out(floor_line(method_floor(device, reps)))
    results = []
    for p in PATTERNS:
        if p.script not in scripts:
            continue
        inputs = pattern_inputs(p, n_rows, device)
        b_ms, term = bound(p, n_rows, rates)
        for layout in LAYOUTS:
            ms = time_pattern(p, inputs, layout, reps)
            out(report_line(p, layout, ms, b_ms, term))
            results.append((p, layout, ms))
    return results


def main(argv=None) -> int:
    scripts = list(argv if argv is not None else sys.argv[1:]) or list(SCRIPTS)
    unknown = [s for s in scripts if s not in SCRIPTS]
    if unknown:
        print(f"unknown script(s) {unknown}; choose from {list(SCRIPTS)}",
              file=sys.stderr)
        return 2
    run_report(scripts, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The one layer that calls the C entries of the port's kernel libraries.

Layers point one way: ``_ext`` builds and loads the libraries and declares
their C interface; this module owns the kernels' argument format, checks
the arguments against it, allocates the outputs, builds the views and calls
the entries; the entry points (``engine.fused_step``, ``engine.fsm``,
``env.environment``, ``models.features``) choose between a kernel and their
plain version with ``card`` and build their own NamedTuples from what the
functions here return (an ``EnvState``'s done, winner, is_draw and key pass
as a sequence and come back as a list).

``card(device, library)`` is the one switch between the card and the plain
versions: ``(lib, stream)`` of the ``nvcc`` build of ``library`` and the
current CUDA stream for a CUDA device, None for any other.  Every launch
function takes that pair first.  ``(host_lib, None)`` runs a host build of
the same source (``csrc/host_emu``) on CPU tensors, which does not count as a
launch; the tests patch ``card`` to return it.

The format.  ``STATE_VIEW``, ``GAME_VIEW``, ``ENV_VIEW``, ``FSM_VIEW`` and
``FEATURE_VIEW`` list, in the order of their ``csrc`` views, each array's
name, dtype and shape after the batch axis.  ``typed`` takes an array as a
kernel reads it: one already in the launcher's dtype, on its device, of its
shape and contiguous is taken as it is after attribute checks alone; any
other gets one conversion (a list or a numpy array becomes a tensor, a host
array or one on another card is copied to the launcher's), counted in
``trace.COUNTERS["wrapper_ops"]``; another shape, or a device the launcher
cannot be handed a copy from, is a ``ValueError`` that names the array.
The feature kernel refuses instead of converting (``exact``).

Each launch function opens the phase ``chunk.launch`` or ``merge.launch`` of
the caller's span around the ctypes call and its error check, and counts
the launch in ``LAUNCHES`` when it ran on the card.
"""

from __future__ import annotations

import torch

from . import _ext, trace
from .agents.simple import FsmState
from .core.constants import AGENT_COUNT, NUM_CELLS
from .engine.cellular import CellState

I32, BOOL, BF16 = torch.int32, torch.bool, torch.bfloat16
POLICY_MOVES = {"harmless": 5, "random": 6, "simple": 5}
FEATURES = 23           # csrc feat::N_FEATURES: bf16 features of a cell
MAX_SLOTS = 16          # csrc feat::MAX_SLOTS: 2 bits an agent id
MAX_VIEW_RANGE = 64     # csrc feat::MAX_VIEW_RANGE

_CPU = torch.device("cpu")
_MASK32 = 0xFFFFFFFF
_PLANE, _AGENT = (NUM_CELLS,), (AGENT_COUNT,)

STATE_VIEW = tuple((name, I32, _PLANE if k < 7 else _AGENT)
                   for k, name in enumerate(CellState._fields[:14]))
GAME_VIEW = STATE_VIEW[:12] + (
    ("agent_can_kick", BOOL, _AGENT), ("agent_dead", BOOL, _AGENT),
    ("alive_count", I32, ()), ("timestep", I32, ()))
ENV_VIEW = (("done", BOOL, ()), ("winner", I32, ()), ("is_draw", BOOL, ()),
            ("key", torch.int64, (3,)))
FSM_VIEW = tuple((f"fsm_state {name}", I32, _AGENT)
                 for name in FsmState._fields)
FEATURE_VIEW = tuple(
    (name, I32, _PLANE) for name in
    ("board", "bomb_timer", "bomb_strength", "bomb_dir", "flame_timer")) + \
    tuple((name, I32, _AGENT) for name in
          ("agent_x", "agent_y", "agent_max_bombs", "agent_bomb_count",
           "agent_strength")) + (("agent_can_kick", BOOL, _AGENT),)

_LOADERS = {"kernels": _ext.lib, "features": _ext.features_lib}
# The chunk's launch counters: [simple][clocked].
_CHUNK_KERNELS = (("rollout_chunk_kernel", "rollout_chunk_clocked_kernel"),
                  ("rollout_chunk_simple_kernel",
                   "rollout_chunk_clocked_simple_kernel"))


def card(device, library: str = "kernels"):
    """``(lib, stream)`` of ``library`` (``"kernels"``: ``fused_step.cu``,
    ``"features"``: ``features.cu``) for tensors on ``device``: the ``nvcc``
    build on the current stream for the card, None for the CPU (the plain
    versions)."""
    if device.type != "cuda":
        return None
    return _LOADERS[library](), torch.cuda.current_stream()


def device(stream) -> torch.device:
    """The device whose memory a launcher on ``stream`` reads (the host
    build's, ``stream=None``: the CPU)."""
    return _CPU if stream is None else stream.device


def _target(stream) -> tuple:
    """``(device, stream pointer)`` of a launch on ``stream``."""
    return (_CPU, None) if stream is None else \
        (stream.device, stream.cuda_stream)


def typed(t, name: str, dtype, shape: tuple, dev):
    """``t`` as a launcher on ``dev`` takes it (see the module
    docstring)."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    elif t.dtype is dtype and t.device == dev and t.shape == shape and \
            t.is_contiguous():
        return t
    on = t.device.type
    if t.shape != shape or (on != dev.type and
                            not (dev.type == "cuda" and on == "cpu")):
        raise ValueError(f"{name} must be {list(shape)} on a {dev.type} "
                         "device")
    trace.COUNTERS["wrapper_ops"] += 1
    return t.to(device=dev, dtype=dtype).contiguous()


def exact(t, name: str, dtype, shape: tuple, dev):
    """``t`` if a launcher on ``dev`` reads it as it is, checked by its
    attributes alone; anything else is refused, not converted."""
    if not (isinstance(t, torch.Tensor) and t.dtype is dtype
            and t.device == dev and t.shape == shape and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {list(shape)} on {dev}")
    return t


def _arrays(table, arrays, b: int, dev, prefix: str = "") -> list:
    """``arrays``, in ``table``'s order, each through ``typed``, whose
    attribute checks run here inline: a mixed step passes 44 arrays."""
    return [t if isinstance(t, torch.Tensor) and t.dtype is dtype
            and t.device == dev and t.shape == (b,) + dims
            and t.is_contiguous()
            else typed(t, prefix + name, dtype, (b,) + dims, dev)
            for t, (name, dtype, dims) in zip(arrays, table)]


def _fsm(fsm_state, b: int, dev) -> list:
    if len(fsm_state) != len(FSM_VIEW):
        raise ValueError("the FSM state has ten arrays")
    return _arrays(FSM_VIEW, fsm_state, b, dev)


def _view(cls, arrays):
    return _ext.view(cls, [t.data_ptr() for t in arrays])


def _fresh_view(fresh, b: int, dev) -> tuple:
    """The GameView of the ``fresh`` test hook's games (all null without
    it) and the arrays it points at, which the caller keeps."""
    if fresh is None:
        return _ext.GameView(), ()
    arrays = _arrays(GAME_VIEW, fresh, b, dev, "fresh ")
    return _view(_ext.GameView, arrays), arrays


def _env_config(team_mode: bool, max_steps: int,
                randomize_positions: bool) -> tuple:
    if not -2 ** 31 <= max_steps < 2 ** 31:
        raise ValueError("max_steps must fit in 32 bits")
    return int(team_mode), int(max_steps), int(randomize_positions)


def chunk_args(policy: str, moves, fsm_state, inject_slots) -> int:
    """Check a chunk's policy arguments; the policy's move count."""
    if policy not in POLICY_MOVES:
        raise ValueError(f"unknown policy {policy!r}")
    if (policy == "simple") != (fsm_state is not None):
        raise ValueError("policy='simple' takes fsm_state (see "
                         "simple_fsm_state_init); other policies do not")
    if inject_slots and (policy != "simple" or moves is None):
        raise ValueError("inject_slots is the mixed-control mode: it needs "
                         "policy='simple' and moves carrying the override lanes")
    if any(s not in range(AGENT_COUNT) for s in inject_slots):
        raise ValueError(f"inject_slots {inject_slots} must name agents 0-3")
    return POLICY_MOVES[policy]


def chunk(lib, stream, cs: CellState, seed: int, steps: int,
          policy: str = "random", moves=None, record: bool = False,
          auto_reset: bool = True, reset_boards=None, fsm_state=None,
          inject_slots=(), prng_rand: bool = False):
    """``engine.fused_step.rollout_chunk`` through the chunk launchers of
    ``lib``: ``rollout_chunk_kernel`` (harmless, random) or, for
    ``policy="simple"``, its SimpleAgent instance; while tracing is on, a
    sampled call (``trace.sample_chunk``) launches the clocked instance.
    ``cs.alive_count`` is not read: the output recounts it.  The outputs
    come in one allocation per group -- the seven planes, the seven agent
    fields (the flags as the kernel's int32, cast to bool after), the ten FSM
    arrays -- so a caller who keeps one array of a group keeps the group."""
    n_moves = chunk_args(policy, moves, fsm_state, inject_slots)
    dev, ptr = _target(stream)
    b = cs.board.shape[0]
    ins = _arrays(STATE_VIEW, cs, b, dev)
    ts = typed(cs.timestep, "timestep", I32, (b,), dev)
    mv = rb = rh = None
    if moves is not None and (inject_slots or not prng_rand):
        mv = typed(moves, "moves", I32, (steps, b, AGENT_COUNT), dev)
    if reset_boards is not None:
        rb, rh = (typed(r, "reset_boards", I32, (b, NUM_CELLS), dev)
                  for r in reset_boards)
    fin = None if fsm_state is None else _fsm(fsm_state, b, dev)
    planes = torch.empty((7, b, NUM_CELLS), dtype=I32, device=dev)
    agents = torch.empty((7, b, AGENT_COUNT), dtype=I32, device=dev)
    args = [_view(_ext.StateView, ins), _ext.view(
        _ext.StateView, _ext.row_ptrs(planes) + _ext.row_ptrs(agents))]
    if fin is not None:
        fout = torch.empty((len(FSM_VIEW), b, AGENT_COUNT), dtype=I32,
                           device=dev)
        args += [_view(_ext.FsmView, fin),
                 _ext.view(_ext.FsmView, _ext.row_ptrs(fout))]
    rec = (None, None)
    if record:
        rec_moves = torch.empty((steps, b, AGENT_COUNT), dtype=I32, device=dev)
        rec_done = torch.empty((steps, b), dtype=I32, device=dev)
        rec = (rec_moves.data_ptr(), rec_done.data_ptr())
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    mv_ptr = None if mv is None else mv.data_ptr()
    rb_ptr, rh_ptr = (None, None) if rb is None else \
        (rb.data_ptr(), rh.data_ptr())
    totals = trace.ON and trace.sample_chunk(dev) or None
    if trace.ON:
        trace.phase("chunk.launch")
    if fin is None:
        err = lib.pomcpp_rollout_chunk(
            *args, b, steps, n_moves, *key, mv_ptr, rb_ptr, rh_ptr,
            int(auto_reset), *rec, totals, ptr)
    else:
        err = lib.pomcpp_rollout_chunk_simple(
            *args, b, steps, *key, mv_ptr,
            sum(1 << s for s in set(inject_slots)), int(prng_rand), rb_ptr,
            rh_ptr, int(auto_reset), *rec, totals, ptr)
    _ext.check(err, lib.pomcpp_error_string)
    if stream is not None:
        _ext.LAUNCHES[_CHUNK_KERNELS[fin is not None][bool(totals)]] += 1
    if trace.ON:
        trace.phase("chunk.out")
    a = agents.unbind(0)
    dead = a[6] != 0
    out = (CellState(*planes.unbind(0), *a[:5], a[5] != 0, dead,
                     AGENT_COUNT - dead.sum(1, dtype=I32), ts + steps),)
    trace.COUNTERS["wrapper_ops"] += 5    # 2 casts, the recount's 2, the step
    if record:
        out += (rec_moves, rec_done != 0)
        trace.COUNTERS["wrapper_ops"] += 1
    if fin is not None:
        out += (FsmState(*fout.unbind(0)),)
    return out if len(out) > 1 else out[0]


def fused_step(lib, stream, cs: CellState, moves) -> CellState:
    """One launch of ``fused_step_kernel`` on ``cs`` in its own dtypes
    (bools as one byte) into new arrays."""
    dev, ptr = _target(stream)
    b = cs.board.shape[0]
    ins = _arrays(GAME_VIEW, cs, b, dev)
    moves = typed(moves, "moves", I32, (b, AGENT_COUNT), dev)
    outs = [torch.empty_like(t) for t in ins]
    _ext.check(lib.pomcpp_fused_step(
        _view(_ext.GameView, ins), _view(_ext.GameView, outs),
        moves.data_ptr(), b, ptr), lib.pomcpp_error_string)
    if stream is not None:
        _ext.LAUNCHES["fused_step_kernel"] += 1
    return CellState(*outs)


def env_step(lib, stream, env, game: CellState, moves, fresh,
             team_mode: bool, max_steps: int, randomize_positions: bool):
    """One launch of ``fused_step_kernel<true>``: the step and the env
    epilogue on ``game`` and ``env`` (done, winner, is_draw, key) into new
    arrays; returns ``(game', [done, winner, is_draw, key])``.  Its phases
    are ``merge.args`` and ``merge.launch``."""
    if trace.ON:
        trace.phase("merge.args")
    dev, ptr = _target(stream)
    cfg = _env_config(team_mode, max_steps, randomize_positions)
    b = game.board.shape[0]
    games = _arrays(GAME_VIEW, game, b, dev)
    env_in = _arrays(ENV_VIEW, env, b, dev)
    moves = typed(moves, "moves", I32, (b, AGENT_COUNT), dev)
    fresh_view, _keep = _fresh_view(fresh, b, dev)
    outs = [torch.empty_like(t) for t in games]
    env_out = [torch.empty_like(t) for t in env_in]
    if trace.ON:
        trace.phase("merge.launch")
    _ext.check(lib.pomcpp_env_step(
        _view(_ext.GameView, games), _view(_ext.EnvView, env_in),
        _view(_ext.GameView, outs), _view(_ext.EnvView, env_out), fresh_view,
        moves.data_ptr(), b, *cfg, ptr), lib.pomcpp_error_string)
    if stream is not None:
        _ext.LAUNCHES["fused_env_step_kernel"] += 1
    return CellState(*outs), env_out


def env_merge(lib, stream, env, game: CellState, fresh, team_mode: bool,
              max_steps: int, randomize_positions: bool):
    """One launch of ``env_merge_kernel``: the env epilogue alone on
    ``game``, a batch already stepped, which it writes IN PLACE (a running
    board only latches its result; a done one takes its fresh game);
    returns ``(game, [done, winner, is_draw, key])``.  Its phases are
    ``merge.args`` and ``merge.launch``."""
    if trace.ON:
        trace.phase("merge.args")
    dev, ptr = _target(stream)
    cfg = _env_config(team_mode, max_steps, randomize_positions)
    b = game.board.shape[0]
    games = _arrays(GAME_VIEW, game, b, dev)
    env_in = _arrays(ENV_VIEW, env, b, dev)
    fresh_view, _keep = _fresh_view(fresh, b, dev)
    env_out = [torch.empty_like(t) for t in env_in]
    if trace.ON:
        trace.phase("merge.launch")
    _ext.check(lib.pomcpp_env_merge(
        _view(_ext.GameView, games), _view(_ext.EnvView, env_in),
        _view(_ext.EnvView, env_out), fresh_view, b, *cfg, ptr),
        lib.pomcpp_error_string)
    if stream is not None:
        _ext.LAUNCHES["env_merge_kernel"] += 1
    return CellState(*games), env_out


def fsm_act(lib, stream, cs: CellState, fsm_state, rand):
    """One launch of ``fsm_act_kernel`` on ``cs`` in its own dtypes;
    returns ``(moves, FsmState)``, the FSM arrays in one allocation."""
    dev, ptr = _target(stream)
    b = cs.board.shape[0]
    ins = _arrays(GAME_VIEW, cs, b, dev)
    fin = _fsm(fsm_state, b, dev)
    rand = typed(rand, "rand", I32, (b, AGENT_COUNT), dev)
    fout = torch.empty((len(FSM_VIEW), b, AGENT_COUNT), dtype=I32, device=dev)
    moves = torch.empty((b, AGENT_COUNT), dtype=I32, device=dev)
    _ext.check(lib.pomcpp_fsm_act(
        _view(_ext.GameView, ins), _view(_ext.FsmView, fin),
        _ext.view(_ext.FsmView, _ext.row_ptrs(fout)), rand.data_ptr(),
        moves.data_ptr(), b, ptr), lib.pomcpp_error_string)
    if stream is not None:
        _ext.LAUNCHES["fsm_act_kernel"] += 1
    return moves, FsmState(*fout.unbind(0))


def ego_features(lib, stream, game: CellState, slots, view_range: int,
                 out=None) -> torch.Tensor:
    """One launch of ``ego_features_kernel``: the bf16 features ``[B, L,
    (2R+1)^2 * 23]`` of the agents ``slots``, into ``out`` when it is given.
    Every array must be as the kernel reads it (``exact``); the path makes
    no PyTorch call but the output's allocation when ``out`` is None.  Its
    rows count in ``trace.COUNTERS["feature_rows"]``, on the host build
    too."""
    ids = [int(s) for s in slots]
    n = len(ids)
    if not 0 < n <= MAX_SLOTS or not all(0 <= s < AGENT_COUNT for s in ids):
        raise ValueError(f"slots must name 1 to {MAX_SLOTS} agents 0-3, "
                         f"not {slots}")
    if not 0 <= view_range <= MAX_VIEW_RANGE:
        raise ValueError(f"view_range must lie in 0-{MAX_VIEW_RANGE}")
    dev, ptr = _target(stream)
    b = game.board.shape[0]
    ptrs = [exact(getattr(game, name), name, dtype, (b,) + dims, dev)
            .data_ptr() for name, dtype, dims in FEATURE_VIEW]
    w = 2 * view_range + 1
    shape = (b, n, w * w * FEATURES)
    out = torch.empty(shape, dtype=BF16, device=dev) if out is None else \
        exact(out, "out", BF16, shape, dev)
    _ext.check(lib.pomcpp_ego_features(
        _ext.view(_ext.FeatureView, ptrs), out.data_ptr(), b, n,
        sum(s << 2 * k for k, s in enumerate(ids)), view_range, ptr),
        lib.pomcpp_features_error_string)
    if stream is not None:
        _ext.LAUNCHES["ego_features_kernel"] += 1
    trace.COUNTERS["feature_rows"] += b * n
    return out

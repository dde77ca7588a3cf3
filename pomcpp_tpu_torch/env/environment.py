"""Game orchestration over batches of boards.

Counterpart of ``pomcpp_tpu.env.environment``.  The environment is a
NamedTuple of tensors, ``EnvState``, and plain functions over it; every
function takes a batch (leading axis B on every field) and is the batched
form of its JAX counterpart -- there is no ``vmap`` here:

* ``env_reset(seed, b)``            -- B fresh games
* ``env_step(es, moves)``           -- one step + terminal detection; a
                                       finished game is frozen
* ``env_step_auto_reset(es, moves)``-- same, but a finished game restarts
                                       on its next step
* ``env_step_auto_reset_batch(es, moves, fused=True)`` -- the same step
  in one launch on the card: ``fused_step_kernel<true>`` steps the boards
  and runs the env epilogue (done latch, terminal detection, the Philox
  reset of finished boards) on the EnvState in its own dtypes, with no
  host read
* ``env_step_auto_reset_batch_fsm(...)`` -- mixed control: SimpleAgent
  opponents act inside the chunk kernel (``rollout_chunk`` with
  ``steps=1``), learner lanes are injected; on the card the epilogue
  follows as ``env_merge_kernel``: two launches, ``launch.chunk`` and
  ``launch.env_merge``, each array checked once.  It carries the spans
  ``env.step`` -> ``env.args``, ``chunk``, ``merge`` of ``trace``
* ``act_all`` / ``rollout`` / ``rollout_stateful`` -- policy loops

Two engines, chosen by the game's type as the JAX ``_step_fn`` chooses:
the plane-encoded ``CellState`` steps through ``cellular_step`` (the port's
default, ``engine="cellular"``), the queue-encoded ``State`` through the
exact conformance engine ``engine.step.step`` (``engine="exact"``, the JAX
package's default; ``env_reset_np(seed)`` gives the reference's own board
for a seed).  The fused paths (``fused=True``, the mixed-control step) are
CellState-only, as in JAX.

Reset stream.  JAX keys cannot be reproduced, so ``EnvState.key`` is the
port's own reset stream: i64[B, 3] holding, per board, ``(seed, board id,
resets drawn so far)``.  A reset draws its board from Philox4x32-10
(``engine.fused_step.philox4x32``) keyed by ``seed``, at the counter words
``(board id, resets drawn so far, stream, cell // 4)`` with stream
``STREAM_ENV_CELLS = 3`` for the cell classes, ``STREAM_ENV_FLAGS = 4`` for
the powerup flags and ``STREAM_ENV_SEATS = 5`` (fourth word 0) for the seat
permutation of ``randomize_positions``; the reset then advances the third
key column by one.  The chunk kernel's streams are 0, 1 and 2 in the same
counter word (``STREAM_MOVES/CELLS/FLAGS``), so an env reset never repeats
a chunk's draws even under the same seed.  A reset therefore needs no host
generator; it is a pure function of the key row.  Cell classes and flags
are read from the 30-bit draws exactly as ``fresh_terrain`` reads them
(same distribution as ``random_board_fast``).  An exact game's reset
(``core.board_gen.random_state``) draws from the same counter words, with
stream ``STREAM_ENV_RANKS = 6`` ranking the wood cells of which exactly
``ceil(n_wood / 2)`` carry a flag.

Parity with the JAX package goes through ``fresh=``: a ``CellState`` batch
that replaces the port's own reset draw (the test computes the JAX side's
fresh games from its keys and injects them), and through ``rand_moves=`` of
the mixed-control step.

Policies.  A policy is ``policy(generator, game, agent_ids) -> moves``:
``generator`` a ``torch.Generator`` (or whatever source of randomness the
policy expects; it is passed through untouched), ``game`` the ``CellState``
batch, ``agent_ids`` an i32 tensor [A]; the result is i32[B, A].  See
``agents.basic``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import launch, trace
from ..core.board_gen import (
    STREAM_ENV_CELLS,
    STREAM_ENV_FLAGS,
    STREAM_ENV_SEATS,
    cell_draws,
    init_state_np,
    key_words,
    put_agents_in_corners_perm,
    random_state,
    seat_perm,
    terrain_of,
)
from ..core.constants import AGENT_COUNT, C_WOOD
from ..core.state import I32, State, map_state, put_agents_in_corners
from ..device import resolve_device
from ..engine.cellular import CellState, cellular_step, empty_cell_state
from ..engine.fused_step import fused_step, rollout_chunk
from ..engine.step import step as exact_step

ENGINES = ("cellular", "exact")

# Classic Pommerman 2v2 teams: agents {0, 2} vs {1, 3}.
TEAM_OF = (0, 1, 0, 1)


class EnvState(NamedTuple):
    game: CellState
    done: torch.Tensor     # bool[B]
    winner: torch.Tensor   # i32[B], agent id (team id in team mode) or -1
    is_draw: torch.Tensor  # bool[B]
    key: torch.Tensor      # i64[B, 3]: seed, board id, resets drawn so far


def _game_map(fn, *games):
    """Apply ``fn`` field-wise over games of one type (CellState or
    State)."""
    if isinstance(games[0], State):
        return map_state(fn, *games)
    return CellState(*map(fn, *games))


def _step_fn(game):
    """Dispatch on the state representation: exact queues vs cellular
    planes (the JAX ``_step_fn``)."""
    return exact_step if isinstance(game, State) else cellular_step


def _env_to_device(es: EnvState, device) -> EnvState:
    moved = []

    def to(t):
        out = t.to(device)
        if out is not t:
            moved.append(out)
        return out

    out = EnvState(_game_map(to, es.game), *map(to, es[1:]))
    if moved:
        trace.COUNTERS["wrapper_ops"] += len(moved)
    return out


def _where_env(mask, a: EnvState, b: EnvState) -> EnvState:
    """Per board: ``a`` where ``mask`` else ``b``, over every field."""
    def pick(x, y):
        return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

    return EnvState(_game_map(pick, a.game, b.game), *map(pick, a[1:], b[1:]))


def _draw_fresh_game(key, randomize_positions: bool,
                     engine: str = "cellular"):
    """The reset boards of the key rows ``key`` (see the module docstring)."""
    if engine == "exact":
        return random_state(key, randomize_positions)
    n, dev = key.shape[0], key.device
    streams = (STREAM_ENV_CELLS, STREAM_ENV_FLAGS) + \
        ((STREAM_ENV_SEATS,) if randomize_positions else ())
    words = key_words(key, streams)
    draws = cell_draws(words[:, :2])
    tmp, flags = draws[:, 0] % 7, draws[:, 1]
    board = terrain_of(tmp)
    hidden = torch.where(
        (board == C_WOOD) & ((flags & 1) == 0), (flags >> 1) % 4 + 1, 0
    )
    cs = empty_cell_state(n, dev)._replace(board=board, hidden_pow=hidden)
    if not randomize_positions:
        return put_agents_in_corners(cs)
    return put_agents_in_corners_perm(cs, seat_perm(words[:, 2]))


def _fresh(key, randomize_positions: bool = False, game=None,
           engine: str = "cellular") -> EnvState:
    """Fresh games for the key rows; ``game`` replaces the port's draw."""
    n, dev = key.shape[0], key.device
    if game is None:
        game = _draw_fresh_game(key, randomize_positions, engine)
    step = torch.tensor([0, 0, 1], dtype=torch.int64, device=dev)
    return EnvState(
        game=game,
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        winner=torch.full((n,), -1, dtype=I32, device=dev),
        is_draw=torch.zeros(n, dtype=torch.bool, device=dev),
        key=key + step,
    )


def _check_fused_game(game) -> None:
    if isinstance(game, State):
        raise ValueError("the fused paths step the kernels, which take the "
                         "plane-encoded CellState only; build the batch with "
                         "env_reset(..., engine='cellular')")


def _engine_of(game) -> str:
    return "exact" if isinstance(game, State) else "cellular"


def env_reset(seed: int, b: int, randomize_positions: bool = False,
              engine: str = "cellular", device=None) -> EnvState:
    """``b`` fresh games on ``device`` (None: the card).

    ``engine="cellular"`` (the port's default) gives plane-encoded
    ``CellState`` games, ``engine="exact"`` queue-encoded ``State`` games
    for the exact conformance engine (the JAX package's default).
    ``randomize_positions`` draws which agent sits in which corner (the
    reference ``MakeGame``'s optional shuffle); off by default.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")
    if not 0 <= seed < 2 ** 63:
        raise ValueError("seed must be in [0, 2^63)")
    device = resolve_device(device)
    key = torch.zeros((b, 3), dtype=torch.int64, device=device)
    key[:, 0] = seed
    key[:, 1] = torch.arange(b, device=device)
    return _fresh(key, randomize_positions, engine=engine)


def env_reset_np(seed: int = 0x1337, device=None, **kw) -> EnvState:
    """One exact game on the reference's own board for ``seed`` (drawn on
    the host, ``core.board_gen.init_state_np``): a batch of one.  Its key
    row is ``(seed, 0, 0)``."""
    game = init_state_np(seed, device=device, **kw)
    dev = game.board.device
    return EnvState(
        game=game,
        done=torch.zeros(1, dtype=torch.bool, device=dev),
        winner=torch.full((1,), -1, dtype=I32, device=dev),
        is_draw=torch.zeros(1, dtype=torch.bool, device=dev),
        key=torch.tensor([[seed, 0, 0]], dtype=torch.int64, device=dev),
    )


def _detect_terminal(es: EnvState, team_mode: bool = False,
                     max_steps: int = 0) -> EnvState:
    """Win/draw latching after a step.

    FFA: the last agent standing wins; nobody alive is a draw.  Team mode:
    a team wins when every opponent is dead, ``winner`` then holds the team
    id (0 or 1); both teams wiped out is a draw.  ``max_steps > 0`` also
    ends the game as a draw once ``timestep`` reaches it.
    """
    dead = es.game.agent_dead
    if team_mode:
        team = torch.tensor(TEAM_OF, device=dead.device)
        t0_alive = (~dead & (team == 0)).any(1)
        t1_alive = (~dead & (team == 1)).any(1)
        won = t0_alive ^ t1_alive
        survivor = torch.where(t0_alive, 0, 1).to(I32)
        draw = ~t0_alive & ~t1_alive
    else:
        won = es.game.alive_count == 1
        # First alive agent; with exactly one survivor any rule agrees.
        survivor = (~dead).to(I32).argmax(1).to(I32)
        draw = es.game.alive_count == 0
    if max_steps:
        draw = draw | (~won & (es.game.timestep >= max_steps))
    return es._replace(
        done=es.done | won | draw,
        winner=torch.where(won & ~es.done, survivor, es.winner),
        is_draw=es.is_draw | (draw & ~es.done),
    )


def _prepare(es: EnvState, moves, device):
    device = resolve_device(device)
    mv = torch.as_tensor(moves).to(device=device, dtype=I32)
    trace.COUNTERS["wrapper_ops"] += mv is not moves
    return _env_to_device(es, device), mv, device


def env_step(es: EnvState, moves, team_mode: bool = False,
             max_steps: int = 0, device=None) -> EnvState:
    """One simultaneous step (``cellular_step``, or the exact ``step`` on a
    ``State`` game) + timestep advance + terminal detection.  A finished
    game is frozen: stepping it is a no-op.
    """
    es, moves, _ = _prepare(es, moves, device)
    game = _step_fn(es.game)(es.game, moves)
    game = game._replace(timestep=game.timestep + 1)
    nxt = _detect_terminal(es._replace(game=game), team_mode, max_steps)
    return _where_env(es.done, es, nxt)


def _merge_done_and_reset(es: EnvState, game: CellState, team_mode: bool,
                          max_steps: int, randomize_positions: bool = False,
                          fresh=None) -> EnvState:
    """Done-latch and auto-reset merge shared by every auto-reset path.

    ``game`` is the stepped batch, timestep advanced.  Both selections use
    ``es.done`` of *before* the step: a board that finishes now latches its
    result and keeps its terminal state for one step; a board that was
    already done is replaced by a fresh game keyed from ``es.key``.
    ``fresh`` (test hook) is a batch of games of ``game``'s type taken
    instead of the port's own reset draw.

    This is the plain version of the env kernels' epilogue
    (``csrc/env_warp.cuh``), which the env functions run on CPU tensors.
    Without ``fresh`` the reset boards are drawn on demand, for the done
    boards only (one device-to-host read per step); drawing for every board
    (``fresh=_draw_fresh_game(es.key, ...)``, what the jitted JAX code does)
    gives the same result.
    """
    nxt = _detect_terminal(es._replace(game=game), team_mode, max_steps)
    if fresh is not None:
        return _where_env(es.done, _fresh(es.key, randomize_positions, fresh),
                          nxt)
    idx = es.done.nonzero()[:, 0]          # host read: which boards reset
    if idx.numel() == 0:
        return nxt
    new = _fresh(es.key[idx], randomize_positions, engine=_engine_of(game))

    def put(x, y):
        return x.index_copy(0, idx, y)

    return EnvState(_game_map(put, nxt.game, new.game),
                    *map(put, nxt[1:], new[1:]))


def env_step_auto_reset(es: EnvState, moves, team_mode: bool = False,
                        max_steps: int = 0, randomize_positions: bool = False,
                        fresh=None, device=None) -> EnvState:
    """``env_step``, but a game that finished restarts on its next step.

    The episode outcome is readable for exactly one step (the step that set
    ``done``).  ``randomize_positions`` applies to the restarted games.  An
    exact game (``State``) restarts as an exact game; ``fresh`` (test hook)
    is a batch of games of the same type replacing the port's reset draw.
    """
    es, moves, _ = _prepare(es, moves, device)
    game = _step_fn(es.game)(es.game, moves)
    game = game._replace(timestep=game.timestep + 1)
    return _merge_done_and_reset(es, game, team_mode, max_steps,
                                 randomize_positions, fresh)


def _rand_lanes(moves, rands, slots: tuple):
    """The chunk's moves when the FSM's rands are handed in (the
    ``rand_moves`` hook): the learner lanes ``slots`` of ``moves``, the
    others of ``rands`` (two operations)."""
    lane = torch.zeros(AGENT_COUNT, dtype=torch.bool, device=moves.device)
    lane[list(slots)] = True
    trace.COUNTERS["wrapper_ops"] += 2
    return torch.where(lane, moves, rands)


def env_step_auto_reset_batch(es: EnvState, moves, team_mode: bool = False,
                              fused: bool = False, max_steps: int = 0,
                              randomize_positions: bool = False, fresh=None,
                              device=None) -> EnvState:
    """Auto-reset step of the whole batch.

    ``fused=True`` on the card is ONE launch of ``fused_step_kernel<true>``
    and no host read: the boards that were done before the step are reset
    from their key rows (or from ``fresh``), the others take the fused step
    -- explosion chains capped at 4 rounds per step, as in the JAX
    package's fused path -- and latch their result.  On CPU tensors the
    same function is ``fused_step_plain`` followed by
    ``_merge_done_and_reset``, the plain version.  ``fused=False`` steps
    through ``cellular_step`` (chains uncapped) and equals
    ``env_step_auto_reset``.
    """
    if not fused:
        return env_step_auto_reset(es, moves, team_mode, max_steps,
                                   randomize_positions, fresh, device)
    _check_fused_game(es.game)
    card = launch.card(resolve_device(device))
    if card:
        game, env = launch.env_step(*card, es[1:], es.game, moves, fresh,
                                    team_mode, max_steps, randomize_positions)
        return EnvState(game, *env)
    es, moves, device = _prepare(es, moves, device)
    game = fused_step(es.game, moves, device=device)
    game = game._replace(timestep=game.timestep + 1)
    return _merge_done_and_reset(es, game, team_mode, max_steps,
                                 randomize_positions, fresh)


def env_step_auto_reset_batch_fsm(es: EnvState, learner_moves, fsm_state,
                                  learner_slots, seed: int,
                                  team_mode: bool = False, max_steps: int = 0,
                                  rand_moves=None,
                                  randomize_positions: bool = False,
                                  fresh=None, device=None):
    """Mixed-control step: SimpleAgent opponents inside the chunk kernel,
    learner moves injected.

    Same env semantics as ``env_step_auto_reset_batch``, but the lanes not
    in ``learner_slots`` act through the FSM of ``engine.fsm`` inside
    ``rollout_chunk(steps=1, policy="simple")`` -- on the card one launch of
    the simple chunk kernel, then one of ``env_merge_kernel``, which writes
    the epilogue into the chunk's output in place.  ``fsm_state`` is the
    ten-array state (``simple_fsm_state_init``); ``seed`` keys the Philox
    draws of the FSM's rands and must differ from step to step.
    ``rand_moves`` (i32[B, 4], tests) supplies those draws instead; the
    learner lanes of the merged input are the override moves either way.
    Returns ``(EnvState, fsm_state')``; the caller owns resetting the
    ``fsm_state`` rows of finished boards.

    On the card the step is ``launch.chunk`` and ``launch.env_merge``, the
    test hooks too: each array is checked once by its attributes and only
    what is not in the kernels' dtypes is converted.  There the outputs of
    a group share one allocation -- the seven planes, the five int32 agent
    fields (with the chunk's int32 flags), the ten FSM arrays -- so a caller
    who keeps one array of a group keeps the whole group alive.
    """
    span = trace.ON and trace.begin("env.step")
    try:
        if span:
            trace.phase("env.args")
        _check_fused_game(es.game)
        slots = tuple(learner_slots)
        card = launch.card(resolve_device(device))
        if card:
            chunk = span and trace.begin("chunk")
            if chunk:
                trace.phase("chunk.args")
            b, dev = es.game.board.shape[0], launch.device(card[1])
            mv = launch.typed(learner_moves, "moves", I32, (b, AGENT_COUNT),
                              dev)
            if rand_moves is not None:
                mv = _rand_lanes(mv, launch.typed(
                    rand_moves, "rand_moves", I32, (b, AGENT_COUNT), dev), slots)
            game, fsm2 = launch.chunk(
                *card, es.game, seed, 1, "simple", mv.view(1, b, AGENT_COUNT),
                auto_reset=False, fsm_state=fsm_state, inject_slots=slots,
                prng_rand=rand_moves is None)
            if chunk:
                trace.end(chunk)
            merge = span and trace.begin("merge")
            game, env = launch.env_merge(*card, es[1:], game, fresh, team_mode,
                                         max_steps, randomize_positions)
            if merge:
                trace.end(merge)
            return EnvState(game, *env), fsm2
        es, learner_moves, device = _prepare(es, learner_moves, device)
        mv = learner_moves
        if rand_moves is not None:
            rm = torch.as_tensor(rand_moves).to(device=device, dtype=I32)
            trace.COUNTERS["wrapper_ops"] += rm is not rand_moves
            mv = _rand_lanes(learner_moves, rm, slots)
            rand_moves = rm
        game, fsm2 = rollout_chunk(
            es.game, seed, 1, "simple", moves=mv[None], auto_reset=False,
            fsm_state=fsm_state, inject_slots=slots,
            prng_rand=rand_moves is None, device=device,
        )
        merge = span and trace.begin("merge")
        out = _merge_done_and_reset(es, game, team_mode, max_steps,
                                    randomize_positions, fresh)
        if merge:
            trace.end(merge)
        return out, fsm2
    finally:
        if span:
            trace.end(span)


def act_all(policy, generator, game: CellState) -> torch.Tensor:
    """One policy for all four agents of every board -> i32[B, 4] moves.

    Dead agents get IDLE (the step never reads a dead agent's move).
    """
    ids = torch.arange(AGENT_COUNT, dtype=I32, device=game.board.device)
    moves = policy(generator, game, ids)
    return torch.where(game.agent_dead, 0, moves).to(I32)


def _stepper(auto_reset: bool, team_mode: bool, max_steps: int, device):
    base = env_step_auto_reset if auto_reset else env_step

    def stepper(es, moves):
        return base(es, moves, team_mode=team_mode, max_steps=max_steps,
                    device=device)

    return stepper


def _stack_metrics(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _metrics(es: EnvState):
    return {"done": es.done, "winner": es.winner,
            "alive": es.game.alive_count}


def rollout(es: EnvState, policy, n_steps: int, auto_reset: bool = True,
            team_mode: bool = False, max_steps: int = 0, generator=None,
            device=None):
    """Run ``n_steps`` with ``policy`` controlling all agents.

    Returns ``(final_env, metrics)``; ``metrics`` holds ``done``,
    ``winner`` and ``alive`` stacked over time, [n_steps, B] each.
    ``generator`` is handed to the policy (see the module docstring).
    """
    device = resolve_device(device)
    es = _env_to_device(es, device)
    stepper = _stepper(auto_reset, team_mode, max_steps, device)
    rows = []
    for _ in range(n_steps):
        es = stepper(es, act_all(policy, generator, es.game))
        rows.append(_metrics(es))
    return es, _stack_metrics(rows)


def _map_state(fn, *states):
    """Apply ``fn`` leaf-wise over policy states: a tensor, or a (named)
    tuple of policy states."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    mapped = [_map_state(fn, *leaves) for leaves in zip(*states)]
    return type(first)(*mapped) if hasattr(first, "_fields") else \
        type(first)(mapped)


def rollout_stateful(es: EnvState, act_fn, policy_state, n_steps: int,
                     auto_reset: bool = True, reset_policy_state=None,
                     joint: bool = False, team_mode: bool = False,
                     max_steps: int = 0, generator=None, device=None):
    """Rollout for stateful policies (e.g. the SimpleAgent FSM).

    ``act_fn(generator, game, agent_ids, pstate) -> (moves, pstate')`` with
    ``moves`` i32[B, 4]; ``policy_state`` is a tensor or a (named) tuple of
    tensors with leading axis B.  ``joint=True`` drops ``agent_ids`` from
    the call.  When ``auto_reset`` is on and ``reset_policy_state`` is
    given, the state of a board that was done before the step is replaced
    by it.  Returns ``(final_env, policy_state, metrics)``.
    """
    device = resolve_device(device)
    es = _env_to_device(es, device)
    stepper = _stepper(auto_reset, team_mode, max_steps, device)
    ids = torch.arange(AGENT_COUNT, dtype=I32, device=device)
    rows = []
    for _ in range(n_steps):
        if joint:
            moves, ps_new = act_fn(generator, es.game, policy_state)
        else:
            moves, ps_new = act_fn(generator, es.game, ids, policy_state)
        moves = torch.where(es.game.agent_dead, 0, moves).to(I32)
        if auto_reset and reset_policy_state is not None:
            done = es.done

            def pick(f, s):
                return torch.where(
                    done.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)

            ps_new = _map_state(pick, reset_policy_state, ps_new)
        policy_state = ps_new
        es = stepper(es, moves)
        rows.append(_metrics(es))
    return es, policy_state, _stack_metrics(rows)

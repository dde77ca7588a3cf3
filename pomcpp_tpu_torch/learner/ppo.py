"""Self-play PPO learner over the port's environment.

Counterpart of ``pomcpp_tpu.learner.ppo``: all four agents share one
actor-critic policy (or a learner plays against scripted or frozen
opponents), rollouts step the whole batch of boards through the env layer
-- on the card, ``fused_env=True`` is one launch of
``fused_step_kernel<true>`` per step in self-play, and the simple chunk
kernel plus ``env_merge_kernel`` against in-kernel SimpleAgents -- and the
update is clipped PPO with GAE.

Tracing (``trace``, off by default).  ``ppo_train_step`` is the span
``ppo.step``, with ``ppo.collect`` (``collect_rollout_batch``; each
``env.step`` of the rollout nests in it), ``ppo.act`` (each call of
``_policy_slots``: features, forward, draw and ``logp``; the bootstrap
value's included), ``ppo.gae`` and ``ppo.update`` inside it, and
``ppo.features`` (the features, ``models.features.ego_features``) inside
each ``ppo.act``; each of these functions called alone is a root.  The
counters ``COUNTERS["model_rows"]`` (rows through the forward in
``_policy_slots``) and ``COUNTERS["update_rows"]`` (rows through the
update's forward and backward, each epoch again) are always on and counted
from shapes.

The iteration's records.  ``ppo_train_step(..., record=d)`` fills the dict
``d`` with references to what the iteration made -- ``traj``, ``adv``,
``ret``, ``boot_value``, ``seeds`` (the mixed-control steps' seeds, ints)
and ``losses`` (each minibatch's loss, detached, in order) -- with no copy
and no device operation.  The parameters and the optimizer's state are
updated in place, so a caller who checks an iteration snapshots them
before it.

Rewards (per agent, sparse): +1 on the step their game ends won; -1 on the
step they die; 0 otherwise.

Randomness.  The port's ``EnvState.key`` is its reset stream, not a key to
split, so the learner draws from the generators of its ``TrainState``:
``gen`` (on the model's device) for policy sampling, scripted opponents'
draws and the minibatch permutation; ``host_gen`` (CPU) for the seed of
each mixed-control step, which must differ from step to step.  Nothing in
a rollout reads the device from the host.

The JAX package has two collectors with one semantics: ``collect_rollout``
(one board, vmapped) and ``collect_rollout_batch``.  The port has the
batched one only; its unfused self-play branch is the one the vmapped form
runs.  Trajectories are time-major (``[T, B, L, ...]``), in buffers
allocated once per rollout.

Test hooks of ``collect_rollout_batch``, in the style of the env's: ``moves``
(i32[T, B, L]) replaces the sampled learner moves (``logp`` is then of the
injected move), ``fresh`` (a list of T ``CellState`` batches) is handed to
the env's ``fresh=`` at each step, ``rand_moves`` (i32[T, B, 4]) to the
mixed-control step's ``rand_moves=``; ``opp_moves`` (i32[T, B, 4]) replaces
the draws of the random, harmless and lazy opponents, ``opp_rands``
(i32[T, B, 4]) the rands of the unfused SimpleAgent opponents, and
``frozen_moves`` (i32[T, B, F]) the frozen net's sampled moves.

Data parallelism.  Given a ``parallel.BoardsMesh``, ``ppo_update`` and
``ppo_train_step`` compute what the JAX package's global-batch ``jit``
computes, each rank holding its boards: the loss all-reduces the masked
weight sum and the advantage's masked sums before it normalises (data, not
functions of the weights), so each rank's loss is its rows' weighted sum
over the global weight sum; the gradients are summed over the ranks before
the global-norm clip; the metrics are summed too.  With
``shuffle_minibatches=False`` and ``minibatches`` dividing
``rollout_len``, a rank's slab ``i`` is its rows of the global slab ``i``
(the flat batch is time-major), so a W-rank update equals the 1-rank
update of the same global batch up to summation order.  ``ppo_init``'s
``rank`` folds the rank into the generators' seeds, not the weights'.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from ..agents.basic import harmless_agent, lazy_agent, random_agent
from ..agents.simple import simple_agent_init
from ..agents.simple_cellular import simple_agent_cell_joint
from ..core.constants import AGENT_COUNT
from ..core.state import I32
from ..device import resolve_device
from ..env.environment import (
    TEAM_OF,
    EnvState,
    _env_to_device,
    act_all,
    env_step_auto_reset_batch,
    env_step_auto_reset_batch_fsm,
)
from ..env.observation import DEFAULT_VIEW_RANGE
from ..models.actor_critic import N_FEATURES, ActorCritic
from ..models.features import ego_features
from ..parallel.mesh import all_reduce_sum, fold_seed


def _spanned(name: str):
    """Run the function inside the trace span ``name`` while tracing is on
    (one global check when it is off)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not trace.ON:
                return fn(*args, **kwargs)
            span = trace.begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                trace.end(span)
        return call
    return wrap


class PPOConfig(NamedTuple):
    """The JAX ``PPOConfig``: same fields, same defaults (see there)."""

    rollout_len: int = 64
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    epochs: int = 2
    minibatches: int = 2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.5
    team_mode: bool = False
    fused_env: bool = False
    opponent: str = ""
    learner_slots: tuple = (0, 1, 2, 3)
    frozen_slots: tuple = ()
    max_episode_steps: int = 800
    draw_penalty: float = 0.0
    shuffle_minibatches: bool = True
    view_range: int = DEFAULT_VIEW_RANGE
    randomize_positions: bool = False


class TrainState(NamedTuple):
    """The model and its optimizer (updated in place), the generators, the
    key the state was made from (u32[2], a JAX ``PRNGKey``'s layout; what a
    checkpoint stores) and the number of updates."""

    model: ActorCritic
    optimizer: torch.optim.Adam
    gen: torch.Generator
    host_gen: torch.Generator
    key: Any
    update_count: int


def _optimizer(model: ActorCritic, cfg: PPOConfig) -> torch.optim.Adam:
    """optax ``adam(lr)``; the global-norm clip before it is
    ``clip_by_global_norm_``."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the gradients of ``params``, in
    place: scale by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
    (``clip_grad_norm_`` would add 1e-6 to the norm).  No host read.
    Returns the norm."""
    grads = [p.grad for p in params]
    g_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm * max_norm))
    return g_norm


def ppo_init(seed: int, cfg: PPOConfig = PPOConfig(),
             device=None, rank: int = 0) -> TrainState:
    """A fresh learner on ``device`` (None: the card).  The weights are drawn
    on the CPU from ``seed``, so every device and rank starts from the same
    net; the generators draw from ``seed`` with ``rank`` folded in
    (``parallel.fold_seed``)."""
    device = resolve_device(device)
    init = torch.Generator().manual_seed(seed)
    model = ActorCritic(view_range=cfg.view_range, generator=init).to(device)
    draws = fold_seed(seed, rank)
    return TrainState(
        model=model,
        optimizer=_optimizer(model, cfg),
        gen=torch.Generator(device=device).manual_seed(draws),
        host_gen=torch.Generator().manual_seed(draws),
        key=np.array([seed >> 32 & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
        update_count=0,
    )


def sample_categorical(gen: torch.Generator, logits: torch.Tensor,
                       uniforms=None):
    """One draw per row of ``logits`` by Gumbel-max, as
    ``jax.random.categorical`` draws (uniforms in [tiny, 1)).  ``uniforms``
    (the shape of ``logits``) replaces the draw."""
    if uniforms is None:
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=logits.dtype)
    else:
        u = torch.as_tensor(uniforms).to(device=logits.device,
                                         dtype=logits.dtype)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(-1)


@_spanned("ppo.act")
def _policy_slots(model, game, gen, slots, view_range: int = DEFAULT_VIEW_RANGE,
                  moves=None, out=None):
    """Sample net moves for the agents ``slots`` of every board ->
    ``(moves i32[B, L], logp, value, feats bf16[B, L, H*W*C])``;
    ``moves`` (i32[B, L]) replaces the draw; the features are written into
    ``out`` when it is given (the rollout's trajectory row)."""
    span = trace.ON and trace.begin("ppo.features")
    feats = ego_features(game, slots, view_range, out)
    if span:
        trace.end(span)
    b, n = feats.shape[:2]
    trace.COUNTERS["model_rows"] += b * n
    logits, value = model(feats.reshape(b * n, -1))
    logits = logits.reshape(b, n, -1)
    if moves is None:
        moves = sample_categorical(gen, logits)
    moves = moves.to(device=logits.device, dtype=torch.int64)
    logp = F.log_softmax(logits, -1).gather(-1, moves[..., None])[..., 0]
    return moves.to(I32), logp, value.reshape(b, n), feats


def opponent_state_init(batch: int, cfg: PPOConfig | None = None,
                        device=None):
    """Fresh per-board scripted-opponent state: the chunk kernel's ten FSM
    arrays with ``cfg.fused_env`` and a simple opponent, else the toolkit
    FSM's ``SimpleAgentState`` [B, 4] (threaded, and ignored, for the
    stateless opponents)."""
    if (cfg is not None and cfg.fused_env
            and cfg.opponent in ("simple", "frozen+simple")):
        from ..engine.fsm import simple_fsm_state_init

        return simple_fsm_state_init(batch, device)
    return simple_agent_init((batch, AGENT_COUNT), device)


_BASIC = {"random": random_agent, "harmless": harmless_agent,
          "lazy": lazy_agent}


def _opponent_moves_batch(name, gen, games, opp_state, draws=None):
    """Scripted moves for all four slots of every board -> (i32[B, 4],
    state').  ``draws`` (i32[B, 4]) replaces what ``gen`` would draw: the
    SimpleAgent's rands, or the other policies' moves."""
    if name == "simple":
        b = games.board.shape[0]
        rands = draws if draws is not None else torch.randint(
            0, 5, (b, AGENT_COUNT), generator=gen, device=gen.device,
            dtype=I32)
        moves, _, opp2 = simple_agent_cell_joint(games, opp_state, rands)
        return torch.where(games.agent_dead, 0, moves).to(I32), opp2
    if draws is not None:
        return torch.where(games.agent_dead, 0, draws).to(I32), opp_state
    return act_all(_BASIC[name], gen, games), opp_state


class Transition(NamedTuple):
    """One rollout, time-major: leaves ``[T, B, L, ...]`` or ``[T, B]``
    (see the JAX ``Transition`` for each field's meaning)."""

    feats: torch.Tensor   # bf16[T, B, L, H*W*C]
    move: torch.Tensor    # i32[T, B, L]
    logp: torch.Tensor    # f32[T, B, L]
    value: torch.Tensor   # f32[T, B, L]
    reward: torch.Tensor  # f32[T, B, L]
    alive: torch.Tensor   # bool[T, B, L] the agent was alive when acting
    done: torch.Tensor    # bool[T, B] episode boundary after this step
    term: torch.Tensor    # bool[T, B, L] board boundary or own death
    draw: torch.Tensor    # bool[T, B] that boundary ended with no winner
    valid: torch.Tensor   # bool[T, B] False for the step auto-reset replaces


def _empty_transition(t: int, b: int, n: int, feat: int, device) -> Transition:
    def buf(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return Transition(
        feats=buf((t, b, n, feat), torch.bfloat16),
        move=buf((t, b, n), I32), logp=buf((t, b, n), torch.float32),
        value=buf((t, b, n), torch.float32),
        reward=buf((t, b, n), torch.float32), alive=buf((t, b, n), torch.bool),
        done=buf((t, b), torch.bool), term=buf((t, b, n), torch.bool),
        draw=buf((t, b), torch.bool), valid=buf((t, b), torch.bool))


def _on(values, dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied without waiting for the
    device (a blocking host-to-device copy would synchronise)."""
    return torch.tensor(tuple(values), dtype=dtype).to(device, non_blocking=True)


def _model_device(model, device) -> torch.device:
    device = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != device.type:
        raise ValueError(f"the model is on {where}, the run on {device}")
    return where


def _roles(cfg: PPOConfig):
    """(learner slots, frozen slots, scripted slots, scripted policy)."""
    slots = tuple(cfg.learner_slots) if cfg.opponent else tuple(
        range(AGENT_COUNT))
    frozen = ()
    if cfg.opponent in ("frozen", "frozen+simple"):
        frozen = tuple(cfg.frozen_slots) or tuple(
            s for s in range(AGENT_COUNT) if s not in slots)
        if set(frozen) & set(slots):
            raise ValueError(f"frozen slots {frozen} overlap the learner's "
                             f"{slots}")
    scripted = tuple(s for s in range(AGENT_COUNT)
                     if s not in slots and s not in frozen) \
        if cfg.opponent else ()
    if cfg.opponent == "frozen" and scripted:
        raise ValueError("opponent='frozen' leaves slots with no policy; use "
                         "'frozen+simple' or widen frozen_slots/learner_slots")
    name = "simple" if cfg.opponent == "frozen+simple" else cfg.opponent
    return slots, frozen, scripted, name


def _reset_rows(done, fresh, state):
    """``fresh`` where ``done`` (per board) else ``state``, leaf-wise."""
    def pick(f, s):
        return torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)

    return type(state)(*map(pick, fresh, state))


@_spanned("ppo.collect")
@torch.no_grad()
def collect_rollout_batch(model, es: EnvState, cfg: PPOConfig, gen,
                          opp_state=None, frozen_model=None, host_gen=None,
                          moves=None, fresh=None, rand_moves=None,
                          opp_moves=None, opp_rands=None, frozen_moves=None,
                          device=None, record=None):
    """Roll ``cfg.rollout_len`` steps of the whole batch.

    Returns ``(final_env, Transition [T, B, L, ...], boot_value f32[B, L])``
    and, with ``cfg.opponent`` set, the opponents' state as a fourth
    element.  With an opponent only the learner slots are stored; the
    others act through the scripted policy, in the chunk kernel for a
    simple opponent under ``fused_env``, or through ``frozen_model`` for
    ``opponent="frozen"`` / ``"frozen+simple"``.  ``gen`` draws the moves,
    ``host_gen`` (a CPU generator) the mixed-control steps' seeds; it may be
    None only when ``rand_moves`` is given.  The rollout runs on ``device``
    (None: the card), where the model must be.  ``record`` (a dict) gets
    ``seeds``, the steps' seeds (0 where no mixed-control step draws one).
    See the module docstring for the hooks.
    """
    slots, frozen, scripted, scripted_name = _roles(cfg)
    if frozen and frozen_model is None:
        raise ValueError(f"opponent={cfg.opponent!r} needs frozen_model")
    dev = _model_device(model, device)
    es = _env_to_device(es, dev)
    game = es.game
    b, n, steps = game.board.shape[0], len(slots), cfg.rollout_len
    w = 2 * cfg.view_range + 1
    traj = _empty_transition(steps, b, n, w * w * N_FEATURES, dev)
    simple_opp = bool(scripted) and scripted_name == "simple"
    in_kernel = simple_opp and cfg.fused_env
    seeds = [0] * steps
    if in_kernel and rand_moves is None:
        if host_gen is None:
            raise ValueError("the mixed-control step needs host_gen for its "
                             "seeds")
        seeds = torch.randint(0, 2 ** 31 - 1, (steps,),
                              generator=host_gen).tolist()
    if record is not None:
        record["seeds"] = seeds
    fresh_opp = opponent_state_init(b, cfg, dev) if simple_opp else None
    opp = fresh_opp if opp_state is None else opp_state
    sl, fz = _on(slots, torch.int64, dev), _on(frozen, torch.int64, dev)
    team = _on(TEAM_OF if cfg.team_mode else range(AGENT_COUNT), I32, dev)[None]
    env_kw = dict(team_mode=cfg.team_mode, max_steps=cfg.max_episode_steps,
                  randomize_positions=cfg.randomize_positions, device=dev)
    for t in range(steps):
        game = es.game
        moves_l, logp, value, _ = _policy_slots(
            model, game, gen, slots, cfg.view_range,
            None if moves is None else moves[t], out=traj.feats[t])
        alive_before = ~game.agent_dead
        if cfg.opponent:
            if scripted and not in_kernel:
                draws = opp_rands if scripted_name == "simple" else opp_moves
                mv, opp = _opponent_moves_batch(
                    scripted_name, gen, game, opp,
                    None if draws is None else
                    torch.as_tensor(draws[t]).to(device=dev, dtype=I32))
            else:
                mv = torch.zeros_like(game.agent_x)
            mv = mv.index_copy(1, sl, moves_l)
            if frozen:
                moves_f = _policy_slots(
                    frozen_model, game, gen, frozen, cfg.view_range,
                    None if frozen_moves is None else frozen_moves[t])[0]
                mv = mv.index_copy(1, fz, moves_f)
        else:
            mv = moves_l
        mv = torch.where(game.agent_dead, 0, mv)
        fr = None if fresh is None else fresh[t]
        if in_kernel:
            es2, opp = env_step_auto_reset_batch_fsm(
                es, mv, opp, slots + frozen, seeds[t],
                rand_moves=None if rand_moves is None else rand_moves[t],
                fresh=fr, **env_kw)
        else:
            es2 = env_step_auto_reset_batch(es, mv, fused=cfg.fused_env,
                                            fresh=fr, **env_kw)
        if fresh_opp is not None:
            # A board that auto-reset starts its opponents from fresh FSMs.
            opp = _reset_rows(es.done, fresh_opp, opp)
        died = alive_before & ~es.done[:, None] & es2.game.agent_dead
        ended = es2.done & ~es.done
        new_done = ended[:, None]
        won = new_done & (team == es2.winner[:, None]) & alive_before
        reward = won.float() - died.float()
        if cfg.draw_penalty:
            drew = (new_done & (es2.winner[:, None] < 0) & alive_before
                    & ~es2.game.agent_dead)
            reward = reward - cfg.draw_penalty * drew.float()
        traj.move[t] = mv.index_select(1, sl)
        traj.logp[t] = logp
        traj.value[t] = value
        traj.reward[t] = reward.index_select(1, sl)
        traj.alive[t] = alive_before.index_select(1, sl)
        traj.done[t] = ended
        traj.term[t] = (new_done | died).index_select(1, sl)
        traj.draw[t] = ended & (es2.winner < 0)
        traj.valid[t] = ~es.done
        es = es2
    boot_value = _policy_slots(model, es.game, gen, slots, cfg.view_range,
                               moves=torch.zeros((b, n), dtype=I32,
                                                 device=dev))[2]
    if cfg.opponent:
        return es, traj, boot_value, opp
    return es, traj, boot_value


@_spanned("ppo.gae")
def compute_gae(traj: Transition, boot_value, cfg: PPOConfig):
    """GAE over the time axis of a time-major trajectory -> (adv, ret),
    f32[T, B, L].  Truncation is per agent (``term``: the board's end or
    the agent's own death)."""
    adv = torch.empty_like(traj.value)
    gae = torch.zeros_like(boot_value)
    next_value = boot_value
    for t in reversed(range(traj.value.shape[0])):
        nonterminal = 1.0 - traj.term[t].float()
        delta = traj.reward[t] + cfg.gamma * next_value * nonterminal \
            - traj.value[t]
        gae = delta + cfg.gamma * cfg.lam * nonterminal * gae
        adv[t] = gae
        next_value = traj.value[t]
    return adv, adv + traj.value


def _ppo_loss(model, batch, cfg: PPOConfig, mesh=None):
    """Clipped PPO loss of a flat minibatch ``(feats, move, old_logp, adv,
    ret, mask)`` -> (loss, metrics).  With ``mesh``, the rows are this
    rank's part of the global minibatch: the weight and advantage sums are
    summed over the ranks, and the loss is this rank's share of the global
    one (see the module docstring)."""
    feats, move, old_logp, adv, ret, alive = batch
    logits, value = model(feats)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(1, move.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    w = alive.float()
    # Masked advantage normalization: junk (invalid/dead) entries must not
    # shift the statistics of the real ones.
    sums = all_reduce_sum(torch.stack([w.sum(), (adv * w).sum()]), mesh)
    wsum = sums[0] + 1e-8
    adv_mean = sums[1] / wsum
    adv_std = torch.sqrt(all_reduce_sum(
        (torch.square(adv - adv_mean) * w).sum(), mesh) / wsum)
    adv_n = (adv - adv_mean) / (adv_std + 1e-8)
    unclipped = ratio * adv_n
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -(torch.minimum(unclipped, clipped) * w).sum() / wsum
    v_loss = (torch.square(value - ret) * w).sum() / wsum
    entropy = (-(torch.exp(logp_all) * logp_all).sum(-1) * w).sum() / wsum
    loss = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    return loss, {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
                  "entropy": entropy}


def sum_gradients(params, mesh) -> None:
    """Sum the gradients of ``params`` over the ranks of ``mesh``, in one
    all-reduce of one flat buffer (no-op without a mesh)."""
    if mesh is None:
        return
    grads = [p.grad for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def optimizer_step(ts: TrainState, cfg: PPOConfig, mesh=None) -> None:
    """Sum the gradients over the ranks (with ``mesh``), clip them by their
    global norm, then one Adam step."""
    params = list(ts.model.parameters())
    sum_gradients(params, mesh)
    clip_by_global_norm_(params, cfg.max_grad_norm)
    ts.optimizer.step()


def _sum_metrics(metrics: dict, mesh) -> dict:
    """The metrics summed over the ranks, in one all-reduce."""
    if mesh is None:
        return metrics
    total = all_reduce_sum(torch.stack(list(metrics.values())), mesh)
    return dict(zip(metrics, total.unbind()))


@_spanned("ppo.update")
def ppo_update(ts: TrainState, flat_batch, cfg: PPOConfig, mesh=None,
               record=None):
    """Minibatched clipped-PPO epochs over a flat ``[N, ...]`` batch ->
    ``(ts, metrics of the last minibatch)``.  Each minibatch is gathered on
    its own (``torch.randperm`` on ``ts.gen``); ``shuffle_minibatches=False``
    takes contiguous slabs.  With ``mesh``, the batch is this rank's rows
    and the update is the global one (see the module docstring).
    ``record`` (a dict) gets ``losses``, each minibatch's loss, detached."""
    n = flat_batch[0].shape[0]
    mb = n // cfg.minibatches
    dev = flat_batch[0].device
    metrics = {}
    losses = []
    if record is not None:
        record["losses"] = losses
    for _ in range(cfg.epochs):
        if cfg.shuffle_minibatches:
            perm = torch.randperm(n, generator=ts.gen, device=dev)
        for i in range(cfg.minibatches):
            if cfg.shuffle_minibatches:
                idx = perm[i * mb:(i + 1) * mb]
                sl = tuple(x.index_select(0, idx) for x in flat_batch)
            else:
                sl = tuple(x[i * mb:(i + 1) * mb] for x in flat_batch)
            ts.optimizer.zero_grad(set_to_none=True)
            trace.COUNTERS["update_rows"] += sl[0].shape[0]
            loss, metrics = _ppo_loss(ts.model, sl, cfg, mesh)
            losses.append(loss.detach())
            loss.backward()
            optimizer_step(ts, cfg, mesh)
    metrics = _sum_metrics({k: v.detach() for k, v in metrics.items()}, mesh)
    return ts._replace(update_count=ts.update_count + 1), metrics


def flatten_batch(traj: Transition, adv, ret):
    """The update's flat rows ``(feats, move, logp, adv, ret, mask)`` of a
    time-major trajectory: views, no copy."""
    def flat(x):
        return x.reshape((-1,) + x.shape[3:])

    mask = traj.alive & traj.valid[:, :, None]
    return (flat(traj.feats), flat(traj.move), flat(traj.logp), flat(adv),
            flat(ret), flat(mask))


@_spanned("ppo.step")
def ppo_train_step(ts: TrainState, es_batch: EnvState,
                   cfg: PPOConfig = PPOConfig(), opp_state=None,
                   frozen_model=None, device=None, mesh=None, record=None):
    """One PPO iteration over a batched env on ``device`` (None: the card):
    collect, GAE, update.

    Returns ``(ts, final_env, metrics)`` and, with ``cfg.opponent`` set, the
    opponents' state as a fourth element (thread it back in, or pass None
    to start fresh).  ``metrics`` are device tensors: the last minibatch's
    losses, ``reward_mean`` (reward per finished episode), ``episodes`` and
    ``draws``.  With ``mesh`` (a ``parallel.BoardsMesh``), ``es_batch`` and
    ``opp_state`` are this rank's boards and the update and the metrics
    are the global batch's, equal on every rank.  ``record`` (a dict)
    receives the iteration's records by reference (see the module
    docstring).
    """
    out = collect_rollout_batch(ts.model, es_batch, cfg, ts.gen, opp_state,
                                frozen_model, ts.host_gen, device=device,
                                record=record)
    es_final, traj, boot = out[:3]
    adv, ret = compute_gae(traj, boot, cfg)
    if record is not None:
        record.update(traj=traj, adv=adv, ret=ret, boot_value=boot)
    ts, metrics = ppo_update(ts, flatten_batch(traj, adv, ret), cfg, mesh,
                             record)
    counts = _sum_metrics({"reward": traj.reward.sum(),
                           "episodes": traj.done.sum().float(),
                           "draws": traj.draw.sum().float()}, mesh)
    episodes = counts["episodes"].long()
    metrics["reward_mean"] = counts["reward"] / episodes.clamp_min(1)
    metrics["episodes"] = episodes
    metrics["draws"] = counts["draws"].long()
    if cfg.opponent:
        return ts, es_final, metrics, out[3]
    return ts, es_final, metrics

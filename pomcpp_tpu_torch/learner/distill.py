"""Search distillation: tree-search visit distributions teach the actor-critic.

Counterpart of ``pomcpp_tpu.learner.distill``: AlphaZero-style policy
improvement.  ``search.mcts_moves_chunk`` (or, with ``guided=True``,
``search.mcts_moves_net`` on the current net) plans for every agent of every
board, and the actor-critic of ``learner.ppo`` is trained to imitate the
search: cross-entropy to the root visit distribution, squared error to the
visit-weighted root Q.  An iteration is a search rollout and minibatched
SGD, with no GAE.  On the card the unguided search is ``n_sim *
(max_tree_depth + 1)`` launches of ``rollout_chunk_kernel<false>`` per agent
and env step, and ``fused_env=True`` steps the env with one launch of
``fused_step_kernel<true>``.

Acting during the rollout samples each agent's move from its visit counts
(Gumbel-max over ``log(visits) / act_temperature``).

Randomness comes from the ``TrainState``'s device generator ``gen``: the
search draws, the sampling uniforms and the minibatch permutation.  Test
hooks, as ``learner.ppo``'s: ``draws`` (a list over the rollout's steps of
``{"search": [four planners' draws, one per agent], "uniforms": f32[B, 4,
6]}``), ``fresh`` (a list of T ``CellState`` batches for the env's
``fresh=``) and ``perm`` (the update's row permutation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.constants import AGENT_COUNT
from ..core.state import I32
from ..device import resolve_device
from ..env.environment import EnvState, _env_to_device, env_step_auto_reset_batch
from ..env.observation import DEFAULT_VIEW_RANGE
from ..models.actor_critic import N_FEATURES
from ..models.features import ego_features
from ..search import N_MOVES, mcts_moves_chunk, mcts_moves_net, true_div
from .ppo import (
    PPOConfig,
    TrainState,
    _model_device,
    clip_by_global_norm_,
    ppo_init,
    sample_categorical,
)


class DistillConfig(NamedTuple):
    """The JAX ``DistillConfig``: same fields and defaults, without
    ``interpret`` (the device is the caller's)."""

    rollout_len: int = 8
    max_episode_steps: int = 800
    n_sim: int = 16
    depth: int = 12
    max_tree_depth: int = 6
    lr: float = 3e-4
    value_coeff: float = 0.5
    max_grad_norm: float = 0.5
    num_minibatches: int = 2
    act_temperature: float = 1.0
    fused_env: bool = True
    guided: bool = False      # plan with mcts_moves_net on the current net;
                              # value targets then on its [-1, 1] scale


def distill_init(seed: int, cfg: DistillConfig = DistillConfig(),
                 device=None) -> TrainState:
    """A fresh learner (``ppo_init``'s model and generators) whose Adam
    takes the distillation learning rate."""
    return ppo_init(seed, PPOConfig(lr=cfg.lr), device)


def _all_agent_feats(game) -> torch.Tensor:
    """bf16 [B, 4, F] flat features of every agent of every board."""
    return ego_features(game, tuple(range(AGENT_COUNT)), DEFAULT_VIEW_RANGE)


def _plan(game, cfg: DistillConfig, gen, model, draws, device):
    """Root visits and Q of every agent's search -> f32[B, 4, 6] twice."""
    res = []
    for a in range(AGENT_COUNT):
        d = None if draws is None else draws[a]
        if cfg.guided:
            res.append(mcts_moves_net(
                game, a, model, gen, n_sim=cfg.n_sim,
                max_tree_depth=cfg.max_tree_depth, draws=d, device=device))
        else:
            res.append(mcts_moves_chunk(
                game, a, gen, n_sim=cfg.n_sim, depth=cfg.depth,
                max_tree_depth=cfg.max_tree_depth, draws=d, device=device))
    visits = torch.stack([r[1] for r in res], 1).float()
    return visits, torch.stack([r[2] for r in res], 1)


@torch.no_grad()
def collect_search_rollout(es: EnvState, cfg: DistillConfig, gen,
                           model=None, draws=None, fresh=None, device=None):
    """Roll ``cfg.rollout_len`` steps, planning with tree search for all
    four agents, on ``device`` (None: the card).

    Returns ``(es', feats bf16[T, B, 4, F], probs f32[T, B, 4, 6], value_t
    f32[T, B, 4], weight f32[T, B, 4])``: ``probs`` is the normalised root
    visit distribution, ``value_t`` the visit-weighted root Q and
    ``weight`` masks dead agents and finished boards out of the loss.
    ``model`` is the net of ``guided`` search (on ``device``).  See the
    module docstring for the hooks.
    """
    if cfg.guided:
        if model is None:
            raise ValueError("guided search needs the model")
        device = _model_device(model, device)
    else:
        device = resolve_device(device)
    es = _env_to_device(es, device)
    t_len, b = cfg.rollout_len, es.done.shape[0]
    w = 2 * DEFAULT_VIEW_RANGE + 1
    feats = torch.empty((t_len, b, AGENT_COUNT, w * w * N_FEATURES),
                        dtype=torch.bfloat16, device=device)
    probs = torch.empty((t_len, b, AGENT_COUNT, N_MOVES), device=device)
    value_t = torch.empty((t_len, b, AGENT_COUNT), device=device)
    weight = torch.empty((t_len, b, AGENT_COUNT), device=device)
    for t in range(t_len):
        game = es.game
        step = None if draws is None else draws[t]
        visits, qs = _plan(game, cfg, gen, model,
                           None if step is None else step["search"], device)
        p = visits / visits.sum(-1, keepdim=True).clamp_min(1.0)
        probs[t] = p
        # Summed in move order, as XLA sums six values: the same f32 on
        # every device.
        pq = p * qs
        v = pq[..., 0]
        for k in range(1, N_MOVES):
            v = v + pq[..., k]
        value_t[t] = v
        feats[t] = _all_agent_feats(game)
        weight[t] = (~game.agent_dead & ~es.done[:, None]).float()
        logits = true_div(torch.log(visits.clamp_min(1e-9)),
                          cfg.act_temperature)
        uniforms = None if step is None else step["uniforms"]
        moves = sample_categorical(gen, logits, uniforms)
        moves = torch.where(game.agent_dead, 0, moves).to(I32)
        es = env_step_auto_reset_batch(
            es, moves, fused=cfg.fused_env, max_steps=cfg.max_episode_steps,
            fresh=None if fresh is None else fresh[t], device=device)
    return es, feats, probs, value_t, weight


def _loss(model, batch, cfg: DistillConfig):
    """Distillation loss of a flat minibatch ``(feats [N, F], probs [N, 6],
    value_t [N], weight [N])`` -> (loss, metrics)."""
    feats, probs, value_t, w = batch
    logits, value = model(feats)
    logp = F.log_softmax(logits, -1)
    pol = -(probs * logp).sum(-1)
    vloss = (value - value_t) ** 2
    denom = w.sum().clamp_min(1.0)
    loss = (w * (pol + cfg.value_coeff * vloss)).sum() / denom
    ent = -(w * (torch.exp(logp) * logp).sum(-1)).sum() / denom
    return loss, {"loss": loss, "policy_ce": (w * pol).sum() / denom,
                  "v_loss": (w * vloss).sum() / denom, "entropy": ent}


def distill_update(ts: TrainState, data, cfg: DistillConfig, perm=None):
    """Minibatched SGD over the flat rows ``data`` (feats, probs, value_t,
    weight): one permutation (``perm``, else ``torch.randperm`` on
    ``ts.gen``), ``num_minibatches`` contiguous slabs of it, each a clip
    by global norm and an Adam step.  Returns ``(ts, metrics)``, the
    metrics averaged over the minibatches."""
    n = data[0].shape[0]
    dev = data[0].device
    if perm is None:
        perm = torch.randperm(n, generator=ts.gen, device=dev)
    data = tuple(x.index_select(0, perm.to(dev)) for x in data)
    mb = n // cfg.num_minibatches
    rows = []
    for i in range(cfg.num_minibatches):
        sl = tuple(x[i * mb:(i + 1) * mb] for x in data)
        ts.optimizer.zero_grad(set_to_none=True)
        loss, metrics = _loss(ts.model, sl, cfg)
        loss.backward()
        clip_by_global_norm_(list(ts.model.parameters()), cfg.max_grad_norm)
        ts.optimizer.step()
        rows.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}
    return ts._replace(update_count=ts.update_count + 1), metrics


def az_train_step(ts: TrainState, es: EnvState,
                  cfg: DistillConfig = DistillConfig(), device=None,
                  draws=None, fresh=None, perm=None):
    """One distillation iteration on ``device`` (None: the card), where the
    model must be: search rollout + minibatched SGD.  Returns ``(ts, es',
    metrics)``; ``metrics`` are device tensors."""
    device = _model_device(ts.model, device)
    es, feats, probs, value_t, weight = collect_search_rollout(
        es, cfg, ts.gen, ts.model, draws, fresh, device)

    def flat(x):
        return x.reshape((-1,) + x.shape[3:])

    ts, metrics = distill_update(
        ts, tuple(flat(x) for x in (feats, probs, value_t, weight)), cfg,
        perm)
    return ts, es, metrics

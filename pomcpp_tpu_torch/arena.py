"""Batched evaluation arena: play line-ups of policies, keep Elo ratings.

Counterpart of ``pomcpp_tpu.arena``: ``play_games`` runs a 4-slot line-up
over a batch of boards, and ``League`` keeps Elo ratings over a roster by
scoring pairwise outcomes.  Used by ``evaluate.py`` (one line-up) and
``league.py`` (a round-robin Elo tournament).

Each slot acts once a step for the whole batch (not per board in a vmap):
the scripted policies of ``agents.basic``, the actor-critic (``ppo``), the
planners of ``search`` (``mcts``, ``lookahead``, ``azmcts``) and the
SimpleAgent.  Every simple slot of a step comes from ONE ``engine.fsm``
``fsm_act`` call -- on the card one launch of ``fsm_act_kernel`` (the FSM
acts for all four agents and the other slots' decisions are dropped), on
the CPU its plain version.  Dead agents' moves are zeroed, and the boards
step with ``env_step`` (the plane engine, chains uncapped; a finished game
is latched, not reset), as in JAX.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from .agents.basic import harmless_agent, lazy_agent, random_agent
from .core.constants import AGENT_COUNT
from .core.state import I32
from .device import resolve_device
from .engine.fsm import fsm_act, simple_fsm_state_init
from .env.environment import _env_to_device, env_reset, env_step
from .env.observation import observe_ego
from .learner.ppo import sample_categorical
from .models.actor_critic import obs_to_features

_STATELESS = {"random": random_agent, "harmless": harmless_agent,
              "lazy": lazy_agent}
_SEARCH = ("mcts", "lookahead", "azmcts")


class GameResults(NamedTuple):
    done: np.ndarray     # bool[G]
    winners: np.ndarray  # i32[G] agent id (or team id in team mode), -1 none
    draws: np.ndarray    # bool[G]
    steps: int


def _net(nets, name):
    """The model of a net slot: ``nets[name]`` for a dict roster (an unknown
    name is a ``KeyError``, as in JAX), else the one shared model."""
    if isinstance(nets, dict):
        if name not in nets:
            raise KeyError(f"net slot {name!r} not in roster params "
                           f"{sorted(nets)}")
        return nets[name]
    if nets is None:
        raise ValueError(f"slot {name!r} needs a model (nets=)")
    return nets


def _search_moves(kind, game, aid, gen, model, search_kwargs, view_range,
                  draws, device):
    from .search import lookahead_moves, mcts_moves, mcts_moves_net

    kw = dict(search_kwargs or {})
    if kind == "azmcts":
        return mcts_moves_net(game, aid, model, gen, view_range=view_range,
                              draws=draws, device=device, **kw)[0]
    if kind == "mcts":
        return mcts_moves(game, aid, gen, draws=draws, device=device, **kw)[0]
    return lookahead_moves(game, aid, gen, draws=draws, device=device,
                           **kw)[0]


@torch.no_grad()
def play_games(names, games: int, steps: int, nets=None, seed: int = 0,
               team: bool = False, search_kwargs=None, check_every: int = 32,
               view_range: int = 4, device=None, es=None, draws=None,
               moves=None, record=None) -> GameResults:
    """Play ``games`` batched games with the 4-slot line-up ``names``.

    ``names[i]`` is one of random/harmless/lazy/simple/ppo/mcts/lookahead/
    azmcts.  ``ppo`` and ``azmcts`` use ``nets``, an ``ActorCritic`` (the
    JAX function's ``ppo_params``); the planners take ``search_kwargs``
    (e.g. ``{"n_sim": 24, "depth": 12}`` for mcts).  Multi-net line-ups:
    pass ``nets`` as a dict and name slots ``ppo:<key>`` / ``azmcts:<key>``;
    each slot then plays ``nets[name]``.

    The all-done early exit is polled every ``check_every`` steps (a host
    read); finished games are latched by ``env_step``, so overshooting
    costs only frozen steps.  Runs on ``device`` (None: the card), where the
    models must be; randomness from a generator seeded with ``seed + 1``,
    the games from ``env_reset(seed, games)``.

    Test hooks: ``es`` (an ``EnvState``) replaces the fresh games;
    ``draws`` (a list over steps of four per-slot draws) replaces each
    slot's randomness -- i32[G] moves for random and harmless, the FSM's
    rands i32[G] for simple, the Gumbel uniforms f32[G, 6] for ppo, the
    planner's ``draws=`` for the search slots, None for lazy; ``moves``
    (``{slot: i32[T, G]}``) plays those moves in a slot instead of asking
    its policy (a simple slot's FSM still acts, for its state);
    ``record`` (a list) receives each step's moves i32[G, 4] as played.
    """
    if len(names) != AGENT_COUNT:
        raise ValueError(f"a line-up names 4 slots, got {names}")
    device = resolve_device(device)
    if es is None:
        es = env_reset(seed, games, device=device)
    es = _env_to_device(es, device)
    games = es.done.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    fsm = simple_fsm_state_init(games, device)
    simple = [i for i, n in enumerate(names) if n == "simple"]
    forced = moves or {}
    t = 0
    for t in range(steps):
        game = es.game
        slot_draws = [None] * 4 if draws is None else draws[t]
        played = []
        for i, name in enumerate(names):
            kind = name.split(":", 1)[0]
            d = slot_draws[i]
            if name == "simple" or i in forced:
                played.append(None)
            elif kind in _SEARCH:
                model = _net(nets, name) if kind == "azmcts" else None
                played.append(_search_moves(kind, game, i, gen, model,
                                            search_kwargs, view_range, d,
                                            device))
            elif kind == "ppo":
                feats = obs_to_features(
                    observe_ego(game, i, view_range=view_range), view_range)
                logits, _ = _net(nets, name)(feats.reshape(games, -1))
                played.append(sample_categorical(gen, logits, d))
            elif d is not None:
                played.append(torch.as_tensor(d).to(device))
            else:
                ids = torch.full((1,), i, dtype=I32, device=device)
                played.append(_STATELESS[name](gen, game, ids)[:, 0])
        if simple:
            if slot_draws[simple[0]] is None:
                rand = torch.randint(0, 5, (games, AGENT_COUNT),
                                     generator=gen, device=device, dtype=I32)
            else:
                rand = torch.zeros((games, AGENT_COUNT), dtype=I32,
                                   device=device)
                for i in simple:
                    rand[:, i] = torch.as_tensor(slot_draws[i]).to(device)
            fsm_moves, fsm = fsm_act(game, fsm, rand, device=device)
            for i in simple:
                played[i] = fsm_moves[:, i]
        for i, m in forced.items():
            played[i] = torch.as_tensor(m[t]).to(device)
        mv = torch.stack([m.to(I32) for m in played], 1)
        mv = torch.where(game.agent_dead, 0, mv)
        if record is not None:
            record.append(mv)
        es = env_step(es, mv, team_mode=team, device=device)
        if (t + 1) % check_every == 0 and bool(es.done.all()):
            break
    return GameResults(done=es.done.cpu().numpy(),
                       winners=es.winner.cpu().numpy(),
                       draws=es.is_draw.cpu().numpy(), steps=t + 1)


# --- Elo league ---------------------------------------------------------------


def elo_expected(ra: float, rb: float) -> float:
    return 1.0 / (1.0 + 10 ** ((rb - ra) / 400.0))


class League:
    """Elo ratings over a roster of named policies (FFA line-ups).

    Each finished game scores every (winner, loser) pair as a win and every
    pair among non-winners as a draw; unfinished games are ignored.
    """

    def __init__(self, roster, k: float = 16.0, initial: float = 1200.0):
        self.roster = list(roster)
        self.k = k
        self.ratings = {n: float(initial) for n in self.roster}
        self.games_played = {n: 0 for n in self.roster}

    def record(self, lineup, results: GameResults) -> None:
        """Fold a batch of games of ``lineup`` (4 roster names) in.

        All pairwise expectations within one game are computed from the
        ratings as they stood *before* the game (standard multiplayer Elo),
        so the result does not depend on the order of the pairs.
        """
        for g in range(len(results.done)):
            if not results.done[g]:
                continue
            win = int(results.winners[g])
            pre = dict(self.ratings)
            for i, j in itertools.combinations(range(4), 2):
                a, b = lineup[i], lineup[j]
                if a == b:
                    continue
                if results.draws[g] or (win != i and win != j):
                    score_a = 0.5
                else:
                    score_a = 1.0 if win == i else 0.0
                ea = elo_expected(pre[a], pre[b])
                self.ratings[a] += self.k * (score_a - ea)
                self.ratings[b] += self.k * ((1.0 - score_a) - (1.0 - ea))
            for n in set(lineup):
                self.games_played[n] += 1

    def table(self):
        return sorted(
            ((n, self.ratings[n], self.games_played[n]) for n in self.roster),
            key=lambda r: -r[1],
        )

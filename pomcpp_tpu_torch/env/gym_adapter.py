"""Gym-style adapter: numpy in/out ``reset``/``step`` over the port's env.

Counterpart of ``pomcpp_tpu.env.gym_adapter``.  A ``PommermanEnv`` holds a
batched ``EnvState`` on a device (the card unless ``device="cpu"`` is
asked for), steps it through ``cellular_step`` and exposes the gymnasium
5-tuple step API with per-agent observation dicts shaped like classic
Pommerman's (keys ``board``, ``bomb_life``, ``bomb_blast_strength``,
``position``, ``ammo``, ...).  No gym dependency: the protocol is
duck-typed (``reset(seed=)`` -> ``(obs, info)``; ``step(actions)`` ->
``(obs, rewards, terminated, truncated, info)``).

``classic_encoding=True`` emits python-pommerman's observation conventions:
the 0-13 Item scheme (the cell-class codes coincide 1:1,
``CLASSIC_ITEM_TABLE`` is the pinned contract), ``position`` as ``(row,
col)``, ``teammate``/``enemies`` as Item codes, the inclusive
``blast_strength`` (classic 2 == strength 1), float timer planes, and
``step_count``/``game_type``/``bomb_moving_direction``.  Game rules stay
the engine's (flame lifetime 4, bomb timers from 10, simultaneous moves).

Batched mode (``batch_size=N``): actions ``[N, 4]``, rewards ``[N, 4]``,
observation arrays gain a leading batch axis, and finished boards
auto-reset on their next step (rewards/terminated read 0/False on the
reset step itself).  The single env (``batch_size=None``) is a batch of one
with the axis stripped; it follows gym's "call reset() yourself" contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.constants import AGENT_COUNT, BOARD_SIZE, NUM_MOVES
from ..core.state import I32
from ..device import resolve_device
from .environment import TEAM_OF, env_reset, env_step, env_step_auto_reset
from .observation import DEFAULT_VIEW_RANGE, observe, observe_ego

# Classic python-pommerman item codes (pommerman/constants.py Item enum),
# pinned next to the engine's: name -> (ours, classic).
CLASSIC_ITEM_TABLE = {
    "Passage": (0, 0),
    "Rigid": (1, 1),
    "Wood": (2, 2),
    "Bomb": (3, 3),
    "Flames": (4, 4),
    "Fog": (5, 5),
    "ExtraBomb": (6, 6),
    "IncrRange": (7, 7),
    "Kick": (8, 8),
    "AgentDummy": (9, 9),
    "Agent0": (10, 10),
    "Agent1": (11, 11),
    "Agent2": (12, 12),
    "Agent3": (13, 13),
}

# Classic action codes vs the engine's move codes: also 1:1, with Up
# meaning row-1 == y-1.
CLASSIC_ACTION_TABLE = {
    "Stop": (0, 0), "Up": (1, 1), "Down": (2, 2),
    "Left": (3, 3), "Right": (4, 4), "Bomb": (5, 5),
}

_CLASSIC_AGENT_DUMMY = 9
_CLASSIC_AGENT0 = 10
_CLASSIC_GAME_TYPE_FFA = 1
_CLASSIC_GAME_TYPE_TEAM = 2


def _obs_planes(game, fog: str, view_range: int, team_mode: bool,
                classic: bool = False):
    """Per-agent observation dicts (a list of four) for a batch of boards;
    every value is a tensor with the leading axis B.

    ``classic=True`` switches to python-pommerman's conventions where they
    differ: ``position`` becomes (row, col) == (y, x), ``teammate`` /
    ``enemies`` are Item codes (AgentDummy = 9 when absent),
    ``blast_strength`` / ``bomb_blast_strength`` include the bomb's own
    cell, and ``step_count`` / ``game_type`` are added.
    """
    b, dev = game.board.shape[0], game.board.device

    def const(value):
        return torch.as_tensor(value, dtype=I32, device=dev).expand(
            (b,) + np.shape(value))

    def teammate(aid):
        return (aid + 2) % 4 if team_mode else -1

    def classic_extras(aid, position_xy, strength, bombs_strength_plane):
        tm = teammate(aid)
        enemies = [a for a in range(AGENT_COUNT) if a != aid and a != tm]
        codes = [_CLASSIC_AGENT0 + e for e in enemies]
        codes += [_CLASSIC_AGENT_DUMMY] * (3 - len(codes))
        return dict(
            position=position_xy.flip(-1),
            teammate=const(_CLASSIC_AGENT_DUMMY if tm < 0
                           else _CLASSIC_AGENT0 + tm),
            enemies=const(codes),
            blast_strength=strength + 1,
            bomb_blast_strength=torch.where(
                bombs_strength_plane > 0, bombs_strength_plane + 1, 0
            ).to(torch.float32),
            step_count=game.timestep,
            game_type=const(_CLASSIC_GAME_TYPE_TEAM if team_mode
                            else _CLASSIC_GAME_TYPE_FFA),
        )

    if fog == "none":
        def one(aid):
            d = dict(
                board=game.board,
                bomb_life=game.bomb_timer,
                bomb_blast_strength=game.bomb_strength,
                flame_life=game.flame_timer,
                position=torch.stack(
                    [game.agent_x[:, aid], game.agent_y[:, aid]], -1).to(I32),
                ammo=game.agent_max_bombs[:, aid]
                - game.agent_bomb_count[:, aid],
                blast_strength=game.agent_strength[:, aid],
                can_kick=game.agent_can_kick[:, aid],
                alive=~game.agent_dead,
                teammate=const(teammate(aid)),
            )
            if classic:
                d.update(classic_extras(aid, d["position"],
                                        game.agent_strength[:, aid],
                                        game.bomb_strength))
                d["bomb_moving_direction"] = game.bomb_dir.to(torch.float32)
            return d
    else:
        obs_fn = observe if fog == "fog" else observe_ego

        def one(aid):
            o = obs_fn(game, aid, view_range=view_range,
                       teammate=teammate(aid))
            d = dict(
                board=o.board,
                bomb_life=o.bomb_timer,
                bomb_blast_strength=o.bomb_strength,
                flame_life=o.flame_timer,
                position=o.position,
                ammo=o.max_bombs - o.bomb_count,
                blast_strength=o.strength,
                can_kick=o.can_kick,
                alive=o.alive,
                teammate=o.teammate,
            )
            if classic:
                d.update(classic_extras(aid, o.position, o.strength,
                                        o.bomb_strength))
                d["bomb_moving_direction"] = o.bomb_dir.to(torch.float32)
            return d

    return [one(aid) for aid in range(AGENT_COUNT)]


class PommermanEnv:
    """Gym-protocol front end over the batched cellular engine.

    ``fog`` selects the observation: ``"none"`` (full state), ``"fog"``
    (classic 9x9 visibility masking) or ``"ego"`` (egocentric crop, the
    learner's input layout).

    Rewards (per agent): +1 on the step the agent's side wins, -1 on the
    step the agent dies, 0 otherwise.  ``terminated``/``truncated`` are per
    board; ``truncated`` marks draws (the ``max_episode_steps`` cap
    included).  ``device=None`` holds the state on the card.
    """

    metadata = {"render_modes": ["ansi"]}

    def __init__(
        self,
        batch_size: Optional[int] = None,
        fog: str = "none",
        view_range: int = DEFAULT_VIEW_RANGE,
        team_mode: bool = False,
        max_episode_steps: int = 800,
        auto_reset: bool = True,
        classic_encoding: bool = False,
        device=None,
    ):
        if fog not in ("none", "fog", "ego"):
            raise ValueError(f"fog must be 'none', 'fog' or 'ego', not {fog!r}")
        self.batch_size = batch_size
        self.fog = fog
        self.classic_encoding = classic_encoding
        self.view_range = view_range
        self.team_mode = team_mode
        self.max_episode_steps = max_episode_steps
        # Auto-reset is a batched-vector-env convention; the single env
        # follows gym's "call reset() yourself after done" contract.
        self.auto_reset = auto_reset and batch_size is not None
        self.n_agents = AGENT_COUNT
        self.n_actions = NUM_MOVES  # 6: idle/up/down/left/right/bomb
        self.board_shape = (BOARD_SIZE, BOARD_SIZE)
        self.device = resolve_device(device)
        self._es = None

    # -- gym protocol ------------------------------------------------------

    def reset(self, seed: int = 0):
        self._es = env_reset(seed, self.batch_size or 1, device=self.device)
        return self._np_obs(), {"winner": self._np(self._es.winner)}

    def _step(self, es, actions):
        """(next EnvState, reward f32[B, 4]); the reward is computed from
        what the stepper returns, so on the reset step it reads 0."""
        step_one = env_step_auto_reset if self.auto_reset else env_step
        dead_before = es.game.agent_dead | es.done[:, None]
        e2 = step_one(es, actions, team_mode=self.team_mode,
                      max_steps=self.max_episode_steps, device=self.device)
        died = e2.game.agent_dead & ~dead_before
        # Team mode: ``winner`` holds the team id (0/1).
        side = torch.tensor(TEAM_OF if self.team_mode else range(AGENT_COUNT),
                            device=self.device)
        won = ((e2.done & ~es.done) & (e2.winner >= 0))[:, None] \
            & (side == e2.winner[:, None]) & ~dead_before
        return e2, won.to(torch.float32) - died.to(torch.float32)

    def step(self, actions):
        if self._es is None:
            raise RuntimeError("call reset() first")
        actions = np.asarray(actions)
        expect = (4,) if self.batch_size is None else (self.batch_size, 4)
        if actions.shape != expect:
            raise ValueError(f"actions of shape {actions.shape}, "
                             f"expected {expect}")
        actions = torch.from_numpy(
            actions.reshape(-1, 4).astype(np.int32)).to(self.device)
        self._es, reward = self._step(self._es, actions)
        es = self._es
        info = {
            "winner": self._np(es.winner),
            "alive": self._np(~es.game.agent_dead),
            "timestep": self._np(es.game.timestep),
        }
        return (
            self._np_obs(),
            self._np(reward),
            self._np(es.done & ~es.is_draw),
            self._np(es.done & es.is_draw),
            info,
        )

    def render(self) -> str:
        """Board 0 as the JAX front end draws it: ``render_state`` of its
        queue-encoded ``State``, without colour."""
        from ..engine.cellular import board_of, to_state
        from ..render.ascii import render_state

        if self._es is None:
            raise RuntimeError("call reset() first")
        return render_state(to_state(board_of(self._es.game)), color=False)

    def close(self) -> None:
        self._es = None

    # -- helpers -----------------------------------------------------------

    def _np(self, x):
        a = x.detach().cpu().numpy()
        return a[0] if self.batch_size is None else a

    def _np_obs(self):
        obs = _obs_planes(self._es.game, self.fog, self.view_range,
                          self.team_mode, self.classic_encoding)
        out = []
        plane_keys = ["board", "bomb_life", "bomb_blast_strength",
                      "flame_life"]
        if self.classic_encoding:
            plane_keys.append("bomb_moving_direction")
        for agent_obs in obs:
            d = {k: self._np(v) for k, v in agent_obs.items()}
            for k in plane_keys:
                d[k] = d[k].reshape(d[k].shape[:-1] + self._plane_shape())
            if self.classic_encoding:
                # python-pommerman serves the timer planes as floats.
                for k in ("bomb_life", "bomb_blast_strength", "flame_life",
                          "bomb_moving_direction"):
                    d[k] = d[k].astype(np.float64)
                if self.batch_size is None:
                    d["position"] = tuple(int(p) for p in d["position"])
                    # Classic 'alive' is the value list of living agents.
                    d["alive"] = [
                        _CLASSIC_AGENT0 + i
                        for i, a in enumerate(d["alive"]) if a
                    ]
                    d["enemies"] = [int(e) for e in d["enemies"]]
                    d["teammate"] = int(d["teammate"])
            out.append(d)
        return out

    def _plane_shape(self):
        if self.fog == "ego":
            w = 2 * self.view_range + 1
            return (w, w)
        return self.board_shape

"""The actor-critic's egocentric input features of a batch of games.

``ego_features(game, slots, view_range, out=None)`` gives the bf16 features
``[B, L, (2R+1)^2 * 23]`` of the agents ``slots`` of every board, each row
the flat ``[H, W, C]`` block of ``obs_to_features(observe_ego(...))``.

* On CPU tensors it is the plain version (``ego_features_plain``): the
  observation's crop and the feature arrangement of
  ``models.actor_critic.obs_to_features``, as PyTorch operators.
* On the card it is one launch of ``ego_features_kernel``
  (``csrc/features.cu``, ``launch.ego_features``) on the ``CellState``
  arrays as the env step leaves them: five int32 planes, five int32 agent
  fields and ``agent_can_kick`` as bool bytes (``launch.FEATURE_VIEW``),
  each checked once by its attributes (dtype, device, shape, contiguity).
  The path makes no PyTorch call but the output's allocation when ``out`` is
  None; an array in another form is refused, not converted.  ``out`` (a
  contiguous bf16 block of that shape, such as the PPO rollout's trajectory
  row ``traj.feats[t]``) is written in place.

Each launch counts in ``trace.LAUNCHES["ego_features_kernel"]`` and its rows
in ``trace.COUNTERS["feature_rows"]``; the tests' host build of the kernel's
source (``stream=None``) counts rows and no launch.
"""

from __future__ import annotations

import torch

from .. import launch
from ..core.constants import AGENT_COUNT
from ..env.observation import DEFAULT_VIEW_RANGE, observe_ego
from .actor_critic import obs_to_features


def ego_features_plain(game, slots, view_range: int = DEFAULT_VIEW_RANGE):
    """bf16 ``[B, L, (2R+1)^2 * 23]``: ``obs_to_features(observe_ego(...))``
    of the agents ``slots``."""
    if len(slots) == 1:
        obs = observe_ego(game, slots[0], view_range=view_range)
        feats = obs_to_features(obs, view_range)[:, None]
    else:
        feats = obs_to_features(observe_ego(game, None, view_range=view_range),
                                view_range)
        if tuple(slots) != tuple(range(AGENT_COUNT)):
            feats = feats[:, list(slots)]
    return feats.reshape(feats.shape[0], len(slots), -1)


def ego_features(game, slots, view_range: int = DEFAULT_VIEW_RANGE,
                 out=None) -> torch.Tensor:
    """bf16 features ``[B, L, (2R+1)^2 * 23]`` of the agents ``slots`` of
    every board of ``game``, into ``out`` when it is given (see the module
    docstring)."""
    card = launch.card(game.board.device, "features")
    if card is None:
        feats = ego_features_plain(game, slots, view_range)
        return feats if out is None else out.copy_(feats)
    return launch.ego_features(*card, game, slots, view_range, out)

"""The actor-critic's egocentric input features of a batch of games.

``ego_features(game, slots, view_range, out=None)`` gives the bf16 features
``[B, L, (2R+1)^2 * 23]`` of the agents ``slots`` of every board, each row
the flat ``[H, W, C]`` block of ``obs_to_features(observe_ego(...))``.

* On CPU tensors it is the plain version (``ego_features_plain``): the
  observation's crop and the feature arrangement of
  ``models.actor_critic.obs_to_features``, as PyTorch operators.
* On the card it is one launch of ``ego_features_kernel``
  (``csrc/features.cu``) on the ``CellState`` arrays as the env step leaves
  them: five int32 planes, five int32 agent fields and ``agent_can_kick`` as
  bool bytes, each checked once by its attributes (dtype, device, shape,
  contiguity).  The path makes no PyTorch call but the output's allocation
  when ``out`` is None; an array in another form is refused, not converted.
  ``out`` (a contiguous bf16 block of that shape, such as the PPO
  rollout's trajectory row ``traj.feats[t]``) is written in place.

Each launch counts in ``trace.LAUNCHES["ego_features_kernel"]`` and its rows
in ``trace.COUNTERS["feature_rows"]``; the tests' host build of the kernel's
source (``stream=None``) counts rows and no launch.
"""

from __future__ import annotations

import torch

from .. import _ext, trace
from ..core.constants import AGENT_COUNT, NUM_CELLS
from ..core.state import I32
from ..env.observation import DEFAULT_VIEW_RANGE, observe_ego
from .actor_critic import BF16, N_FEATURES, obs_to_features

PLANES = ("board", "bomb_timer", "bomb_strength", "bomb_dir", "flame_timer")
AGENT_INTS = ("agent_x", "agent_y", "agent_max_bombs", "agent_bomb_count",
              "agent_strength")
MAX_SLOTS = 16          # csrc feat::MAX_SLOTS: 2 bits an agent id
MAX_VIEW_RANGE = 64     # csrc feat::MAX_VIEW_RANGE


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


def _card_launcher(device):
    """``(lib, stream)`` of the feature kernel for tensors on ``device``:
    the ``nvcc`` build on the device's current stream for the card, None
    for the CPU (the plain version)."""
    if device.type != "cuda":
        return None
    return _ext.features_lib(), torch.cuda.current_stream(device).cuda_stream


def ego_features(game, slots, view_range: int = DEFAULT_VIEW_RANGE,
                 out=None) -> torch.Tensor:
    """bf16 features ``[B, L, (2R+1)^2 * 23]`` of the agents ``slots`` of
    every board of ``game``, into ``out`` when it is given (see the module
    docstring)."""
    launcher = _card_launcher(game.board.device)
    if launcher is None:
        feats = ego_features_plain(game, slots, view_range)
        return feats if out is None else out.copy_(feats)
    return _ego_features_launch(*launcher, game, slots, view_range, out)


def _pointer(t, name: str, dtype, shape: tuple, dev) -> int:
    """The data pointer of ``t``, which must be ``dtype``, on ``dev``, of
    ``shape`` and contiguous; checked by its attributes alone."""
    if not (isinstance(t, torch.Tensor) and t.dtype is dtype
            and t.device == dev and t.shape == shape and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {list(shape)} on {dev}")
    return t.data_ptr()


def _ego_features_launch(lib, stream, game, slots, view_range: int,
                         out=None) -> torch.Tensor:
    """``ego_features`` through the launcher of ``lib``: one launch on
    ``stream``; ``stream=None`` is the tests' host build of the source on
    CPU tensors, which does not count as a launch."""
    ids = [int(s) for s in slots]
    n = len(ids)
    if not 0 < n <= MAX_SLOTS or not all(0 <= s < AGENT_COUNT for s in ids):
        raise ValueError(f"slots must name 1 to {MAX_SLOTS} agents 0-3, "
                         f"not {slots}")
    if not 0 <= view_range <= MAX_VIEW_RANGE:
        raise ValueError(f"view_range must lie in 0-{MAX_VIEW_RANGE}")
    dev = game.board.device
    b = game.board.shape[0]
    plane, agent = (b, NUM_CELLS), (b, AGENT_COUNT)
    ptrs = [_pointer(getattr(game, f), f, I32, plane, dev) for f in PLANES]
    ptrs += [_pointer(getattr(game, f), f, I32, agent, dev)
             for f in AGENT_INTS]
    ptrs.append(_pointer(game.agent_can_kick, "agent_can_kick", torch.bool,
                         agent, dev))
    w = 2 * view_range + 1
    shape = (b, n, w * w * N_FEATURES)
    if out is None:
        out = torch.empty(shape, dtype=BF16, device=dev)
    code = sum(s << 2 * k for k, s in enumerate(ids))
    _ext.check(lib.pomcpp_ego_features(
        _ext.view(_ext.FeatureView, ptrs),
        _pointer(out, "out", BF16, shape, dev), b, n, code, view_range,
        stream), lib.pomcpp_features_error_string)
    if stream is not None:
        _ext.LAUNCHES["ego_features_kernel"] += 1
    trace.COUNTERS["feature_rows"] += b * n
    return out

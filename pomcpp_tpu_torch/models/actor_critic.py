"""Actor-critic network over egocentric observations.

Counterpart of ``pomcpp_tpu.models.actor_critic``: a small convolutional
torso over the egocentric crop of ``env.observation.observe_ego`` with a
policy head (6 moves) and a value head.  Parameters are float32 and the
torso computes in bfloat16, as flax's ``dtype=jnp.bfloat16`` does: the
input, the kernel and the bias are cast to bf16, the bias is added after
the convolution or matmul, in bf16, and the two heads run in float32 on the
bf16 hidden layer.

Features keep JAX's ``[..., H, W, C]`` order, so a flat feature row means
the same thing in both packages; the torso reads them as a channels-last
NCHW view, and flattens its output in (h, w, c) order, the order of
``Dense_0``'s 5184 input rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.constants import C_AGENT0
from ..env.observation import DEFAULT_VIEW_RANGE

N_MOVES = 6
# Board classes in view: passage..kick (0..8), fog (5) included, 4 agents.
_N_CLASSES = 9 + 4
# One-hot classes, four bomb/flame planes, six own stats.
N_FEATURES = _N_CLASSES + 4 + 6
BF16 = torch.bfloat16


def obs_to_features(obs, view_range: int = DEFAULT_VIEW_RANGE) -> torch.Tensor:
    """Observation -> bf16 features ``[..., H, W, C]`` (C = 23).

    The leading axes are the observation's (``[B]`` or ``[B, 4]``).  Bit
    for bit the JAX function: the scalar planes are f32 divisions of the
    integer values, rounded once to bf16.
    """
    w = 2 * view_range + 1
    lead = obs.board.shape[:-1]
    board = obs.board.reshape(lead + (w, w))
    cls = torch.where(board >= C_AGENT0, board - C_AGENT0 + 9, board)
    classes = torch.arange(_N_CLASSES, dtype=cls.dtype, device=cls.device)
    onehot = (cls.clamp(0, _N_CLASSES - 1)[..., None] == classes).float()
    scalars = torch.stack([
        obs.bomb_timer.reshape(lead + (w, w)) / 10.0,
        obs.bomb_strength.reshape(lead + (w, w)) / 10.0,
        obs.bomb_dir.reshape(lead + (w, w)) / 4.0,
        obs.flame_timer.reshape(lead + (w, w)) / 4.0,
    ], -1)
    stats = torch.stack([
        obs.max_bombs / 5.0,
        obs.bomb_count / 5.0,
        obs.strength / 10.0,
        obs.can_kick.float(),
        obs.position[..., 0] / 10.0,
        obs.position[..., 1] / 10.0,
    ], -1)
    stats = stats[..., None, None, :].expand(lead + (w, w, 6))
    return torch.cat([onehot, scalars, stats], -1).to(BF16)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled so that the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class ActorCritic(nn.Module):
    """Conv torso + policy/value heads over ``[N, H, W, C]`` features (or
    their flat ``[N, H*W*C]`` rows) -> ``(logits f32[N, 6], value f32[N])``.

    Submodules in flax's order: ``convs.0`` / ``convs.1`` (``Conv_0``,
    ``Conv_1``: 3x3 SAME), ``dense`` (``Dense_0``), ``policy``
    (``Dense_1``), ``value`` (``Dense_2``).  ``generator`` seeds the
    initialisation: lecun-normal kernels, zero biases.
    """

    def __init__(self, hidden: int = 128, channels: int = 64, layers: int = 2,
                 view_range: int = DEFAULT_VIEW_RANGE, generator=None):
        super().__init__()
        self.width = 2 * view_range + 1
        ins = [N_FEATURES] + [channels] * (layers - 1)
        self.convs = nn.ModuleList(
            nn.Conv2d(c, channels, 3, padding=1) for c in ins)
        self.dense = nn.Linear(self.width * self.width * channels, hidden)
        self.policy = nn.Linear(hidden, N_MOVES)
        self.value = nn.Linear(hidden, 1)
        for layer in (*self.convs, self.dense, self.policy, self.value):
            fan_in = layer.weight[0].numel()
            lecun_normal_(layer.weight, fan_in, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, features: torch.Tensor):
        w = self.width
        x = features.reshape(-1, w, w, N_FEATURES).to(BF16).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(BF16), None, padding=1)
            x = torch.relu(x + conv.bias.to(BF16)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.linear(x, self.dense.weight.to(BF16))
        h = torch.relu(x + self.dense.bias.to(BF16)).float()
        logits = F.linear(h, self.policy.weight) + self.policy.bias
        value = F.linear(h, self.value.weight) + self.value.bias
        return logits, value[:, 0]

"""The PPO learner's mathematics in plain float32 PyTorch: the reference
that the tests hold ``learner.ppo`` and ``models.actor_critic`` against.

It imports plain ``torch`` alone -- nothing of the port, of the JAX
package or of JAX -- and computes, with no kernel, batching trick or
lower precision of its own:

* ``ego_features``: the egocentric (2R+1) x (2R+1) crop of the board with
  fog (cells farther than R from the agent read as fog; in a crop of width
  2R+1 there are none) and off-board cells read as rigid walls, and its
  23 features a cell: 13 one-hot classes (passage .. kick, fog included,
  then the four agents), the bomb timer, strength and direction and the
  flame timer, and the agent's six own stats;
* ``forward``: the actor-critic (two 3x3 SAME convolutions with ReLU, a
  dense layer with ReLU, a 6-way policy head and a value head);
* ``gae``: generalised advantage estimation, truncated per agent;
* ``ppo_loss``: the clipped PPO loss with masked advantage normalisation,
  the value loss and the entropy bonus; its gradients by autograd;
* ``clip_by_global_norm`` (optax's) and ``adam`` (optax's ``adam``, by its
  formula);
* ``update``: the minibatched epochs of one iteration, on permutations the
  caller draws.

The parameters are a list of tensors in ``ActorCritic.parameters()``'s
order: for each convolution its kernel ``[out, in, 3, 3]`` and bias, then
the dense layer's ``[hidden, H*W*out]`` and bias, the policy head's and the
value head's.

Departures from the program, each on purpose:

* the torso is computed in float32; the program's is bfloat16, as flax's
  ``dtype=jnp.bfloat16`` computes it (inputs, kernels and biases cast to
  bf16, the bias added after the convolution or product, in bf16), with the
  heads in float32 on the bf16 hidden layer;
* features are returned in float32; the program rounds them once to
  bfloat16 (the callers compare the rounded values bit for bit);
* Adam is its formula; the program runs ``torch.optim.Adam``, which
  rounds in another order;
* the crop is read by coordinates from the unpadded planes; the program
  gathers from padded planes.

Every entry point turns off TF32 for float32 products and convolutions
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``), which would round their inputs to
TF32 on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BOARD_SIZE = 11
C_RIGID, C_FOG, C_AGENT0 = 1, 5, 10
N_CLASSES = 13          # passage .. kick (0 .. 8, fog 5 among them), 4 agents
N_FEATURES = N_CLASSES + 4 + 6


def exact_f32() -> None:
    """No TF32 in float32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ego_features(game, slots, view_range: int = 4) -> torch.Tensor:
    """Features f32[B, L, W, W, 23] (W = 2R+1, rows along y) of the agents
    ``slots`` of every board of ``game`` (any object with the cellular
    state's fields: flat i32[B, 121] planes, [B, 4] agent arrays)."""
    r = view_range
    dev = game.board.device
    d = torch.arange(-r, r + 1, device=dev)
    out = []
    for s in slots:
        x = game.agent_x[:, s].long()[:, None, None]
        y = game.agent_y[:, s].long()[:, None, None]
        cx, cy = x + d[None, None, :], y + d[None, :, None]
        on = (cx >= 0) & (cx < BOARD_SIZE) & (cy >= 0) & (cy < BOARD_SIZE)
        cell = (cx.clamp(0, BOARD_SIZE - 1)
                + BOARD_SIZE * cy.clamp(0, BOARD_SIZE - 1)).flatten(1)

        def read(plane, off):
            v = plane.long().gather(1, cell).reshape(on.shape)
            return torch.where(on, v, off)

        board = read(game.board, C_RIGID)
        seen = torch.maximum(d[None, :, None].abs(), d[None, None, :].abs()) <= r
        board = torch.where(seen, board, C_FOG)
        cls = torch.where(board >= C_AGENT0, board - C_AGENT0 + 9, board)
        onehot = (cls.clamp(0, N_CLASSES - 1)[..., None]
                  == torch.arange(N_CLASSES, device=dev)).float()
        planes = torch.stack([
            read(game.bomb_timer, 0).to(torch.int32) / 10.0,
            read(game.bomb_strength, 0).to(torch.int32) / 10.0,
            read(game.bomb_dir, 0).to(torch.int32) / 4.0,
            read(game.flame_timer, 0).to(torch.int32) / 4.0,
        ], -1)
        own = torch.stack([
            game.agent_max_bombs[:, s].to(torch.int32) / 5.0,
            game.agent_bomb_count[:, s].to(torch.int32) / 5.0,
            game.agent_strength[:, s].to(torch.int32) / 10.0,
            game.agent_can_kick[:, s].float(),
            game.agent_x[:, s].to(torch.int32) / 10.0,
            game.agent_y[:, s].to(torch.int32) / 10.0,
        ], -1)
        own = own[:, None, None, :].expand(onehot.shape[:3] + (6,))
        out.append(torch.cat([onehot, planes, own], -1))
    return torch.stack(out, 1)


def forward(params, feats):
    """``feats`` (flat rows f32[N, W*W*23] or [N, W, W, 23]) ->
    ``(logits f32[N, 6], value f32[N])``."""
    exact_f32()
    *convs, dense_w, dense_b, pol_w, pol_b, val_w, val_b = params
    n = feats.shape[0]
    c_in = convs[0].shape[1]
    w = round((feats[0].numel() // c_in) ** 0.5)
    x = feats.reshape(n, w, w, c_in).permute(0, 3, 1, 2).float()
    for k in range(0, len(convs), 2):
        x = torch.relu(F.conv2d(x, convs[k], convs[k + 1], padding=1))
    x = x.permute(0, 2, 3, 1).reshape(n, -1)
    h = torch.relu(x @ dense_w.T + dense_b)
    return h @ pol_w.T + pol_b, (h @ val_w.T + val_b)[:, 0]


def gae(reward, value, term, boot_value, gamma: float, lam: float):
    """Time-major ``[T, ...]`` rewards, values and per-agent truncations
    ``term`` (bool) with the bootstrap value ``[...]`` -> ``(adv, ret)``."""
    adv = torch.zeros_like(value)
    running = torch.zeros_like(boot_value)
    nxt = boot_value
    for t in range(value.shape[0] - 1, -1, -1):
        keep = 1.0 - term[t].float()
        delta = reward[t] + gamma * nxt * keep - value[t]
        running = delta + gamma * lam * keep * running
        adv[t] = running
        nxt = value[t]
    return adv, adv + value


def ppo_loss(params, batch, clip_eps: float, value_coef: float,
             entropy_coef: float):
    """The clipped PPO loss of flat rows ``(feats, move, old_logp, adv, ret,
    mask)`` -> ``(loss, {"pg_loss", "v_loss", "entropy"})``; rows outside
    ``mask`` weigh nothing, in the advantage's statistics too."""
    feats, move, old_logp, adv, ret, mask = batch
    logits, value = forward(params, feats)
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(1, move.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    w = mask.float()
    wsum = w.sum() + 1e-8
    mean = (adv * w).sum() / wsum
    std = torch.sqrt(((adv - mean) ** 2 * w).sum() / wsum)
    adv_n = (adv - mean) / (std + 1e-8)
    surrogate = torch.minimum(ratio * adv_n,
                              ratio.clamp(1 - clip_eps, 1 + clip_eps) * adv_n)
    pg_loss = -(surrogate * w).sum() / wsum
    v_loss = ((value - ret) ** 2 * w).sum() / wsum
    entropy = (-(logp_all.exp() * logp_all).sum(-1) * w).sum() / wsum
    loss = pg_loss + value_coef * v_loss - entropy_coef * entropy
    return loss, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy}


def clip_by_global_norm(grads, max_norm: float):
    """optax ``clip_by_global_norm``: every gradient times ``max_norm /
    norm`` when the global norm is at least ``max_norm``."""
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm)
            for g in grads]


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam(params, grads, m, v, step: int, lr: float, b1: float = ADAM_B1,
         b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """optax ``adam``'s step ``step`` (counted from 1) -> ``(params, m,
    v)``: the moments' moving averages, their bias corrections, and
    ``p - lr * m_hat / (sqrt(v_hat) + eps)``."""
    m = [b1 * mi + (1 - b1) * g for mi, g in zip(m, grads)]
    v = [b2 * vi + (1 - b2) * g * g for vi, g in zip(v, grads)]
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    params = [p - lr * (mi / c1) / (torch.sqrt(vi / c2) + eps)
              for p, mi, vi in zip(params, m, v)]
    return params, m, v


def update(params, m, v, step: int, flat_batch, perms, minibatches: int,
           lr: float, clip_eps: float, value_coef: float, entropy_coef: float,
           max_grad_norm: float):
    """One iteration's update from Adam's state ``(m, v, step)`` over flat
    rows, one epoch a permutation of ``perms`` (None: contiguous slabs),
    each cut into ``minibatches`` -> ``(params, m, v, step, losses)``."""
    n = flat_batch[0].shape[0]
    mb = n // minibatches
    losses = []
    params = [p.detach().float() for p in params]
    for perm in perms:
        for i in range(minibatches):
            rows = torch.arange(i * mb, (i + 1) * mb,
                                device=params[0].device) if perm is None \
                else perm[i * mb:(i + 1) * mb]
            batch = [x.index_select(0, rows) for x in flat_batch]
            leaves = [p.clone().requires_grad_(True) for p in params]
            loss, _ = ppo_loss(leaves, batch, clip_eps, value_coef,
                               entropy_coef)
            grads = torch.autograd.grad(loss, leaves)
            grads = clip_by_global_norm(grads, max_grad_norm)
            step += 1
            params, m, v = adam(params, grads, m, v, step, lr)
            losses.append(loss.detach())
    return params, m, v, step, losses

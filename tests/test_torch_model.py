"""The port's actor-critic, its weight and state conversion and its
optimizer step vs the JAX package on the CPU.

Tolerances, each measured on these inputs and stated where it is used:

* ``obs_to_features``: bit for bit.
* The model (bf16 torso, f32 heads): logits within 0.02 and value within
  0.005 of JAX, argmax equal on every row (measured: 1.6e-5 / 7e-7 with the
  checkpoint, 1.3e-4 / 1.4e-4 with a fresh net).
* ``_ppo_loss``: the loss within 3e-3 relative (measured 7.1e-4 and
  3.5e-7); the gradients per leaf within a relative L2 bound: 0.3 for the
  conv biases, 0.03 for every other leaf (measured up to 0.131 and 0.0085).
  The conv biases' gradients are sums over every position of a bf16
  gradient, which JAX rounds more coarsely: against a float64 evaluation of
  the same loss the port is at least as close as JAX on every leaf (up to
  1.25x JAX's error, measured 1.03x), and that is checked too.
* One clipped Adam step from the checkpoint's optimizer state: the update
  within 1e-6 relative (L2 per leaf) of optax's (measured 6.1e-7), the
  moments within 1e-6 (measured 7.6e-8), the count equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pomcpp_tpu.env import environment as jenv
from pomcpp_tpu.env.observation import observe_ego as jax_observe_ego
from pomcpp_tpu.learner import ppo as jppo
from pomcpp_tpu.models.actor_critic import ActorCritic as JaxActorCritic
from pomcpp_tpu.models.actor_critic import obs_to_features as jax_features
from pomcpp_tpu.utils import restore_checkpoint as jax_restore
from pomcpp_tpu.utils import save_checkpoint as jax_save
from pomcpp_tpu_torch.convert import (
    params_from_jax,
    params_to_jax,
    to_torch,
    train_state_leaves,
)
from pomcpp_tpu_torch.env.environment import env_reset
from pomcpp_tpu_torch.env.observation import observe_ego
from pomcpp_tpu_torch.learner import ppo as tppo
from pomcpp_tpu_torch.models.actor_critic import ActorCritic, obs_to_features
from pomcpp_tpu_torch.utils import checkpoint as tckpt

ARTIFACTS = ("ppo_vs_simple", "ppo_randseat", "ppo_fog4",
             "ppo_team_vs_simple")
B = 64


@pytest.fixture(scope="module")
def jax_state():
    return jppo.ppo_init(jax.random.PRNGKey(0), jppo.PPOConfig())


@pytest.fixture(scope="module")
def jax_params(jax_state):
    ckpt = jax_restore("artifacts/ppo_vs_simple", jax_state)
    return {"ckpt": ckpt.params, "fresh": jax_state.params}


@pytest.fixture(scope="module")
def games():
    """64 boards stepped 12 random steps: bombs and flames in view."""
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    es = jax.vmap(lambda k: jenv.env_reset(k, engine="cellular"))(keys)
    step = jax.jit(jax.vmap(
        lambda e, m: jenv.env_step_auto_reset(e, m, False, 0, False)))
    rng = np.random.RandomState(0)
    for _ in range(12):
        es = step(es, jnp.asarray(rng.randint(0, 6, (B, 4)).astype(np.int32)))
    game = es.game
    assert (np.asarray(game.bomb_timer) > 0).any()
    assert (np.asarray(game.flame_timer) > 0).any()
    return game


def _jax_features(game, view_range):
    return jax.vmap(lambda g: jax.vmap(
        lambda a: jax_features(jax_observe_ego(g, a, view_range=view_range),
                               view_range))(jnp.arange(4)))(game)


def _port_model(params) -> ActorCritic:
    model = ActorCritic()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_from_jax(params).items()})
    return model


def _leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert np.array_equal(x, y), i


def test_params_round_trip(jax_state):
    params = jax.tree.map(np.asarray, jax_state.params)
    back = params_to_jax(params_from_jax(params))
    _leaves_equal(jax.tree.leaves(params), jax.tree.leaves(back))
    model = _port_model(params)
    again = params_to_jax(model.state_dict())
    _leaves_equal(jax.tree.leaves(params), jax.tree.leaves(again))


def test_train_state_leaf_order_is_jax(jax_state):
    """The 33 leaves: params, Adam count, mu, nu, key, update_count, in the
    order, shapes and dtypes of ``jax.tree.leaves(ppo_init(...))``."""
    ref = jax.tree.leaves(jax_state)
    ours = train_state_leaves(tppo.ppo_init(0, tppo.PPOConfig(), "cpu"))
    assert len(ours) == len(ref) == 33
    for i, (a, b) in enumerate(zip(ref, ours)):
        assert np.asarray(a).shape == b.shape and np.asarray(a).dtype == b.dtype, i
    # A fresh state's count, moments, key and update count agree as values.
    _leaves_equal(ref[10:], ours[10:])


@pytest.mark.parametrize("name", ARTIFACTS)
def test_jax_checkpoint_loads_into_the_port(tmp_path, name):
    path = f"artifacts/{name}"
    ts = tckpt.restore_checkpoint(path, tppo.ppo_init(1, device="cpu"))
    _leaves_equal(tckpt.checkpoint_leaves(path), train_state_leaves(ts))
    # Adam's step is optax's count, so bias correction goes on from there.
    state = ts.optimizer.state[ts.model.dense.weight]
    assert float(state["step"]) == float(tckpt.checkpoint_leaves(path)[10])
    # ... and the port writes the same file back.
    tckpt.save_checkpoint(tmp_path, ts)
    _leaves_equal(tckpt.checkpoint_leaves(path),
                  tckpt.checkpoint_leaves(tmp_path))


def test_port_checkpoint_loads_into_jax(tmp_path, jax_state):
    ts = tppo.ppo_init(7, device="cpu")
    batch = tuple(torch.from_numpy(a) for a in (
        np.random.RandomState(0).rand(32, 1863).astype(np.float32),
        np.random.RandomState(1).randint(0, 6, 32).astype(np.int32),
        np.full(32, -1.8, np.float32), np.linspace(-1, 1, 32, dtype=np.float32),
        np.zeros(32, np.float32), np.ones(32, bool)))
    loss, _ = tppo._ppo_loss(ts.model, batch, tppo.PPOConfig())
    loss.backward()
    tppo.optimizer_step(ts, tppo.PPOConfig())
    ts = ts._replace(update_count=5)
    tckpt.save_checkpoint(tmp_path, ts)
    restored = jax_restore(str(tmp_path), jax_state)
    _leaves_equal(train_state_leaves(ts),
                  jax.tree.map(np.asarray, jax.tree.leaves(restored)))
    assert int(restored.opt_state[1][0].count) == 1
    assert int(restored.update_count) == 5
    # JAX's own save of that state reads back into the port unchanged.
    jax_save(str(tmp_path / "again"), restored)
    again = tckpt.restore_checkpoint(tmp_path / "again",
                                     tppo.ppo_init(0, device="cpu"))
    _leaves_equal(train_state_leaves(ts), train_state_leaves(again))


def test_init_is_flax_lecun_normal():
    """Kernels: a normal truncated at 2 sigma, variance 1 / fan_in;
    biases zero; the same seed gives the same net."""
    model = tppo.ppo_init(3, device="cpu").model
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p[0].numel()
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        x = p.detach().numpy().ravel()
        assert np.abs(x).max() <= 2 * std, name
        if x.size > 4000:
            assert abs(x.std() * np.sqrt(fan_in) - 1) < 0.05, name
    again = tppo.ppo_init(3, device="cpu").model
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("view_range", [4, 10])
def test_obs_to_features_bit_exact(games, view_range):
    ref = np.asarray(_jax_features(games, view_range).astype(jnp.float32))
    got = obs_to_features(observe_ego(to_torch(games, "cpu"), None,
                                      view_range=view_range), view_range)
    assert got.dtype == torch.bfloat16
    w = 2 * view_range + 1
    assert got.shape == (B, 4, w, w, 23)
    assert np.array_equal(ref, got.float().numpy())


@pytest.mark.parametrize("which", ["ckpt", "fresh"])
def test_model_matches_jax(games, jax_params, which):
    params = jax_params[which]
    feats = _jax_features(games, 4).reshape(B * 4, 9, 9, 23)
    ref_logits, ref_value = jax.vmap(
        lambda f: JaxActorCritic().apply(params, f))(feats)
    with torch.no_grad():
        logits, value = _port_model(params)(
            torch.from_numpy(np.array(feats.astype(jnp.float32))))
    ref_logits, ref_value = np.asarray(ref_logits), np.asarray(ref_value)
    assert np.abs(logits.numpy() - ref_logits).max() <= 0.02
    assert np.abs(value.numpy() - ref_value).max() <= 0.005
    assert np.array_equal(logits.numpy().argmax(1), ref_logits.argmax(1))
    # Flat rows give the same result as [N, H, W, C].
    with torch.no_grad():
        flat, _ = _port_model(params)(torch.from_numpy(
            np.array(feats.astype(jnp.float32)).reshape(B * 4, -1)))
    assert torch.equal(flat, logits)


def _float64_grads(model, batch, cfg):
    """Gradients of the same loss with every layer in float64."""
    class F64(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, f):
            m = self.m
            x = f.reshape(-1, 9, 9, 23).double().permute(0, 3, 1, 2)
            for conv in m.convs:
                x = torch.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            h = torch.relu(F.linear(x, m.dense.weight, m.dense.bias))
            return (F.linear(h, m.policy.weight, m.policy.bias),
                    F.linear(h, m.value.weight, m.value.bias)[:, 0])

    base = model.double()
    batch = tuple(x.double() if x.is_floating_point() else x for x in batch)
    loss, _ = tppo._ppo_loss(F64(base), batch, cfg)
    loss.backward()
    return params_to_jax({k: p.grad.float() for k, p in base.named_parameters()})


@pytest.mark.parametrize("which", ["ckpt", "fresh"])
def test_loss_and_grads_match_jax(jax_params, which):
    params = jax_params[which]
    cfg_j, cfg_t = jppo.PPOConfig(rollout_len=16), tppo.PPOConfig(rollout_len=16)
    model = _port_model(params)
    # A batch collected by the port from these weights.
    es = env_reset(1, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, traj, boot = tppo.collect_rollout_batch(model, es, cfg_t, gen,
                                               device="cpu")
    adv, ret = tppo.compute_gae(traj, boot, cfg_t)
    batch = tppo.flatten_batch(traj, adv, ret)
    jbatch = tuple(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                   if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())
                   for x in batch)
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        jppo._ppo_loss, has_aux=True)(params, jbatch, cfg_j)
    loss, metrics = tppo._ppo_loss(model, batch, cfg_t)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        3e-3 * abs(float(ref_loss))
    assert set(metrics) == set(ref_m)
    got = params_to_jax({k: p.grad for k, p in model.named_parameters()})
    exact = _float64_grads(_port_model(params), batch, cfg_t)
    for layer, leaves in got["params"].items():
        for k, g in leaves.items():
            ref = np.asarray(ref_g["params"][layer][k])
            bound = 0.3 if layer.startswith("Conv") and k == "bias" else 0.03
            rel = np.linalg.norm(g - ref) / np.linalg.norm(ref)
            assert rel <= bound, (layer, k, rel)
            r64 = exact["params"][layer][k]
            ours = np.linalg.norm(g - r64) / np.linalg.norm(r64)
            theirs = np.linalg.norm(ref - r64) / np.linalg.norm(r64)
            assert ours <= 1.25 * theirs, (layer, k, ours, theirs)


@pytest.mark.parametrize("norm_factor", [2.0, 0.5], ids=["clipped", "unclipped"])
def test_clipped_adam_step_matches_optax(norm_factor):
    """JAX's gradients (global norm above, then below ``max_grad_norm``)
    and the checkpoint's Adam state: one step of each optimizer."""
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    path = "artifacts/ppo_vs_simple"
    ts_j = jax_restore(path, jppo.ppo_init(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        ts_j.params)
    scale = norm_factor * cfg_j.max_grad_norm / float(optax.global_norm(grads))
    grads = jax.tree.map(lambda g: g * scale, grads)
    updates, opt_state = jppo._optimizer(cfg_j).update(
        grads, ts_j.opt_state, ts_j.params)

    ts = tckpt.restore_checkpoint(path, tppo.ppo_init(0, cfg_t, "cpu"))
    port_grads = params_from_jax(grads)
    with torch.no_grad():
        # Adam's update does not read the parameters: from zeros, the
        # parameters after the step ARE the update, with no rounding.
        for name, p in ts.model.named_parameters():
            p.zero_()
            p.grad = torch.from_numpy(port_grads[name].copy())
    tppo.optimizer_step(ts, cfg_t)
    got = params_to_jax(dict(ts.model.named_parameters()))
    for layer, leaves in got["params"].items():
        for k, u in leaves.items():
            ref = np.asarray(updates["params"][layer][k])
            rel = np.linalg.norm(u - ref) / np.linalg.norm(ref)
            assert rel <= 1e-6, (layer, k, rel)
    leaves = train_state_leaves(ts)
    ref = jax.tree.leaves(opt_state)
    assert int(leaves[10]) == int(ref[0]) == 4001
    for a, b in zip(ref[1:], leaves[11:31]):
        a = np.asarray(a, np.float64)
        assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(a)

"""The port's PPO learner against its plain float32 reference
(``pomcpp_tpu_torch/learner/plain.py``) on the CPU.

One learner on seeded random weights trains 2 iterations of 8 boards x 4
steps against three SimpleAgents on the mixed-control step (the step cap of
5 ends every game in the second), 2 minibatches; the second iteration is
recorded (``ppo_train_step(record=...)``) from a snapshot of the weights,
Adam's state and the generators.  Its boards are replayed through the
port's env on the recorded learner moves and the seeds redrawn from the
host generator, and at every step the reference's features of the
replayed game must equal the recorded ones bit for bit once rounded to
bf16.  Then, on the recorded batch:

* the forward: the reference's f32 value and ``logp`` at the recorded
  move (of live agents: a dead agent's stored move is zeroed after its
  ``logp`` was taken) against the program's, within ``TOL``;
* GAE: the reference's on the program's rewards, values, ``term`` and
  bootstrap value, within 1e-6;
* the update: the reference's from the snapshot, on the minibatch
  permutation redrawn after the rollout's draws -- each minibatch's loss
  and the parameters' change (the worst leaf's relative L2) within
  ``TOL``.

Tolerances, each about 4x the largest reading over seeds 0-7 (the
program's torso is bf16, which rounds each layer's output to 8 significant
bits, the reference's f32): ``value`` 9.7e-4 and ``logp`` 1.9e-3 read;
the loss 3.6e-4 (absolute: a minibatch's loss can lie near 0); the
parameters' change 0.126 (the dense layer's bias) -- Adam divides each
element's step by its own gradient scale, so the small gradients of a
16-row minibatch move by the rounding's share of themselves.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
from pomcpp_tpu_torch.env.environment import (
    env_reset,
    env_step_auto_reset_batch_fsm,
)
from pomcpp_tpu_torch.learner import plain
from pomcpp_tpu_torch.learner import ppo as tppo

ROOT = Path(__file__).resolve().parent.parent
B, T = 8, 4
CFG = tppo.PPOConfig(rollout_len=T, epochs=1, minibatches=2,
                     opponent="simple", learner_slots=(0,), fused_env=True,
                     max_episode_steps=5)
TOL = {"value": 0.004, "logp": 0.008, "loss": 0.0015, "update": 0.5}


def _iteration(seed):
    """Two iterations; the second's inputs, snapshot, records and outputs."""
    ts = tppo.ppo_init(seed, CFG, "cpu")
    es = env_reset(seed, B, device="cpu")
    opp = tppo.opponent_state_init(B, CFG, "cpu")
    ts, es, _, opp = tppo.ppo_train_step(ts, es, CFG, opp, device="cpu")
    params = [p.detach().clone() for p in ts.model.parameters()]
    state = [ts.optimizer.state[p] for p in ts.model.parameters()]
    snap = {"params": params,
            "m": [s["exp_avg"].clone() for s in state],
            "v": [s["exp_avg_sq"].clone() for s in state],
            "step": int(state[0]["step"]),
            "gen": ts.gen.get_state(), "host_gen": ts.host_gen.get_state()}
    record = {}
    ts2, es2, _, opp2 = tppo.ppo_train_step(ts, es, CFG, opp, device="cpu",
                                            record=record)
    after = [p.detach().clone() for p in ts2.model.parameters()]
    return {"es": es, "opp": opp, "snap": snap, "record": record,
            "es2": es2, "opp2": opp2, "after": after}


@pytest.fixture(scope="module", params=[0, 1])
def it(request):
    return _iteration(request.param)


def test_features_match_the_plain_crop_bit_for_bit(it):
    rec, snap = it["record"], it["snap"]
    traj = rec["traj"]
    host = torch.Generator()
    host.set_state(snap["host_gen"])
    seeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=host).tolist()
    assert seeds == rec["seeds"]
    es, opp = it["es"], it["opp"]
    fresh = simple_fsm_state_init(B, "cpu")
    for t in range(T):
        want = plain.ego_features(es.game, (0,)).reshape(B, 1, -1)
        assert torch.equal(want.to(torch.bfloat16).view(torch.int16),
                           traj.feats[t].view(torch.int16))
        mv = torch.zeros((B, 4), dtype=torch.int32)
        mv[:, 0] = traj.move[t][:, 0]
        es2, opp2 = env_step_auto_reset_batch_fsm(
            es, mv, opp, (0,), seeds[t], max_steps=CFG.max_episode_steps,
            device="cpu")
        opp = type(opp2)(*(torch.where(es.done[:, None], f, s)
                           for f, s in zip(fresh, opp2)))
        es = es2
    assert all(torch.equal(a, b) for a, b in zip(es.game, it["es2"].game))
    assert not traj.valid.all()           # the cap reset boards in the window


def test_forward_matches_the_plain_f32_model(it):
    traj = it["record"]["traj"]
    logits, value = plain.forward(it["snap"]["params"],
                                  traj.feats.reshape(B * T, -1).float())
    logp = torch.log_softmax(logits, -1).gather(
        1, traj.move.reshape(-1, 1).long())[:, 0]
    alive = traj.alive.reshape(-1)
    assert alive.any()
    assert (value - traj.value.reshape(-1)).abs().max() <= TOL["value"]
    assert (logp - traj.logp.reshape(-1))[alive].abs().max() <= TOL["logp"]


def test_gae_matches_the_plain_recursion(it):
    rec = it["record"]
    traj = rec["traj"]
    adv, ret = plain.gae(traj.reward, traj.value, traj.term,
                         rec["boot_value"], CFG.gamma, CFG.lam)
    assert (adv - rec["adv"]).abs().max() <= 1e-6
    assert (ret - rec["ret"]).abs().max() <= 1e-6


def test_update_matches_the_plain_optimizer(it):
    rec, snap = it["record"], it["snap"]
    traj = rec["traj"]
    gen = torch.Generator()
    gen.set_state(snap["gen"])
    for _ in range(T):
        torch.rand((B, 1, 6), generator=gen)
    perm = torch.randperm(B * T, generator=gen)
    flat = tppo.flatten_batch(traj, rec["adv"], rec["ret"])
    params, _, _, step, losses = plain.update(
        snap["params"], snap["m"], snap["v"], snap["step"], flat, [perm],
        CFG.minibatches, CFG.lr, CFG.clip_eps, CFG.value_coef,
        CFG.entropy_coef, CFG.max_grad_norm)
    assert step == snap["step"] + CFG.minibatches
    assert len(losses) == len(rec["losses"]) == CFG.minibatches
    assert max(abs(float(a) - float(b))
               for a, b in zip(losses, rec["losses"])) <= TOL["loss"]
    worst = max(float(((g - p0) - (r - p0)).norm() / (r - p0).norm())
                for g, r, p0 in zip(it["after"], params, snap["params"]))
    assert worst <= TOL["update"]


def test_plain_reference_imports_torch_alone():
    """By its source and when loaded on its own: no JAX, no JAX package and
    nothing of the port (kernels included)."""
    path = ROOT / "pomcpp_tpu_torch" / "learner" / "plain.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "torch"}
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('plain', {str(path)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "pomcpp_tpu",
                         "pomcpp_tpu_torch"}

"""The port's PPO learner on the CPU: train steps, sampling, the
opponent branches and the ``train_ppo`` entry point.

Its parity with ``pomcpp_tpu.learner.ppo`` is held in
``tests/test_torch_ppo.py`` (the collector and GAE) and
``tests/test_torch_model.py`` (the model, the loss and the optimizer step);
here the port is held to itself: two runs from one seed are bit-equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pomcpp_tpu_torch.convert import diff_fields
from pomcpp_tpu_torch.env.environment import env_reset
from pomcpp_tpu_torch.learner import ppo as tppo

ROOT = Path(__file__).resolve().parent.parent


def _train(seed, cfg, steps=2):
    ts = tppo.ppo_init(seed, cfg, device="cpu")
    es = env_reset(seed + 1, 8, device="cpu")
    opp, rows = None, []
    for _ in range(steps):
        if cfg.opponent:
            ts, es, metrics, opp = tppo.ppo_train_step(ts, es, cfg, opp,
                                                       device="cpu")
        else:
            ts, es, metrics = tppo.ppo_train_step(ts, es, cfg, device="cpu")
        rows.append({k: float(v) for k, v in metrics.items()})
    return ts, es, rows


@pytest.mark.parametrize("kw", [
    dict(fused_env=True),
    dict(fused_env=True, opponent="simple", learner_slots=(0,)),
], ids=["selfplay_fused", "simple_fused"])
def test_train_steps_update_and_repeat(kw):
    cfg = tppo.PPOConfig(rollout_len=8, epochs=2, minibatches=2,
                         max_episode_steps=10, **kw)
    before = [p.detach().clone() for p in
              tppo.ppo_init(0, cfg, device="cpu").model.parameters()]
    ts, es, rows = _train(0, cfg)
    assert ts.update_count == 2
    assert all(not torch.equal(a, b) for a, b in
               zip(before, ts.model.parameters()))
    assert all(np.isfinite(v) for row in rows for v in row.values())
    assert set(rows[0]) == {"loss", "pg_loss", "v_loss", "entropy",
                            "reward_mean", "episodes", "draws"}
    assert rows[1]["episodes"] > 0       # the cap of 10 ends the games
    ts2, es2, rows2 = _train(0, cfg)
    assert rows == rows2
    assert all(torch.equal(a, b) for a, b in
               zip(ts.model.parameters(), ts2.model.parameters()))
    assert not diff_fields(es.game, es2.game, skip=())
    state = ts.optimizer.state[ts.model.dense.weight]
    assert float(state["step"]) == 2 * 2 * 2


def test_gumbel_max_sampling_follows_the_softmax():
    """Chi-square test of 1e5 draws against softmax(logits), 5 degrees of
    freedom: 20.5 is the 0.999 quantile."""
    logits = torch.tensor([[2.0, 0.5, -1.0, 0.0, 1.0, -3.0]]).expand(100_000, 6)
    gen = torch.Generator().manual_seed(0)
    draws = tppo.sample_categorical(gen, logits)
    counts = np.bincount(draws.numpy(), minlength=6)
    expect = torch.softmax(logits[0], 0).numpy() * len(draws)
    assert ((counts - expect) ** 2 / expect).sum() < 20.5


@pytest.mark.parametrize("opponent", ["random", "harmless", "lazy", "simple",
                                      "frozen", "frozen+simple"])
def test_opponent_modes(opponent):
    """Every opponent branch runs, stores only the learner slot, and a lazy
    opponent stands still."""
    kw = dict(rollout_len=4, opponent=opponent, learner_slots=(0,))
    if opponent == "frozen+simple":
        kw.update(frozen_slots=(1,), fused_env=True)
    cfg = tppo.PPOConfig(**kw)
    ts = tppo.ppo_init(0, cfg, device="cpu")
    frozen = tppo.ppo_init(1, cfg, device="cpu").model \
        if opponent.startswith("frozen") else None
    es = env_reset(2, 4, device="cpu")
    fin, traj, boot, opp = tppo.collect_rollout_batch(
        ts.model, es, cfg, ts.gen, frozen_model=frozen, host_gen=ts.host_gen,
        device="cpu")
    assert traj.move.shape == (4, 4, 1) and boot.shape == (4, 1)
    if opponent == "lazy":
        assert (fin.game.agent_x[:, 1:] == es.game.agent_x[:, 1:]).all()
    if opponent == "simple":
        assert type(opp).__name__ == "SimpleAgentState"


def test_collector_needs_its_generators_and_slots():
    cfg = tppo.PPOConfig(rollout_len=2, opponent="simple", learner_slots=(0,),
                         fused_env=True)
    ts = tppo.ppo_init(0, cfg, device="cpu")
    es = env_reset(2, 4, device="cpu")
    with pytest.raises(ValueError, match="host_gen"):
        tppo.collect_rollout_batch(ts.model, es, cfg, ts.gen, device="cpu")
    with pytest.raises(ValueError, match="frozen_model"):
        tppo.collect_rollout_batch(ts.model, es, cfg._replace(
            opponent="frozen"), ts.gen, device="cpu")
    with pytest.raises(ValueError, match="no policy"):
        tppo.collect_rollout_batch(
            ts.model, es, cfg._replace(opponent="frozen", frozen_slots=(1,)),
            ts.gen, frozen_model=ts.model, device="cpu")


def test_train_ppo_script_trains_saves_and_resumes(tmp_path):
    """``python -m pomcpp_tpu_torch.train_ppo`` on the CPU: one metrics
    line per iteration, a checkpoint and a resume bundle that the port and
    its flags read back."""
    from pomcpp_tpu_torch.train_ppo import auto_minibatches

    assert auto_minibatches(2048, 64, 1) == 2
    assert auto_minibatches(4096, 64, 4) == 8
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    ck = tmp_path / "ck"
    base = [sys.executable, "-m", "pomcpp_tpu_torch.train_ppo", "--batch",
            "4", "--rollout", "4", "--epochs", "1", "--opponent", "simple",
            "--learner-slots", "0", "--fused", "--device", "cpu",
            "--ckpt-dir", str(ck)]
    out = subprocess.run(base + ["--iters", "2"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 2 and '"env_steps_per_s"' in lines[0]
    # --resume goes on from the bundle's iteration: range(2, 3).
    out = subprocess.run(base + ["--iters", "3", "--resume"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"resumed full bundle from {ck / 'resume'} at iter 2" in out.stdout
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and '"update": 3' in lines[0]
    # Without the bundle, the weights alone.
    for name in os.listdir(ck / "resume"):
        os.remove(ck / "resume" / name)
    os.rmdir(ck / "resume")
    out = subprocess.run(base + ["--iters", "1", "--resume"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "at update 3 (no env bundle)" in out.stdout
    assert '"update": 4' in out.stdout

"""Resume after a kill reproduces the straight-through run, bit for bit.

The port's counterpart of ``tests/test_resume_equivalence.py``: a run
killed after k iterations and resumed from the full bundle (``TrainState``
with its generator states, env state, opponent state, iteration) gives the
same metrics as the run that never stopped, and ends in the same state.
In-process through ``utils.checkpoint``, and through the
``pomcpp_tpu_torch.train_ppo`` command line with ``--resume``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pomcpp_tpu_torch.convert import train_state_leaves
from pomcpp_tpu_torch.env.environment import env_reset
from pomcpp_tpu_torch.learner import ppo as tppo
from pomcpp_tpu_torch.utils.checkpoint import (
    restore_bundle,
    save_bundle,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {
    "simple": dict(opponent="simple", learner_slots=(0,)),
    "simple_fused": dict(opponent="simple", learner_slots=(0,),
                         fused_env=True),
    "selfplay_fused": dict(fused_env=True),
}


def _cfg(case):
    return tppo.PPOConfig(rollout_len=4, epochs=1, minibatches=2,
                          max_episode_steps=6, **CONFIGS[case])


def _init(cfg, seed=0, batch=8):
    ts = tppo.ppo_init(seed, cfg, device="cpu")
    es = env_reset(seed + 1, batch, device="cpu")
    opp = tppo.opponent_state_init(batch, cfg, "cpu") if cfg.opponent \
        else None
    return ts, es, opp


def _step(ts, es, opp, cfg):
    if cfg.opponent:
        return tppo.ppo_train_step(ts, es, cfg, opp, device="cpu")
    ts, es, m = tppo.ppo_train_step(ts, es, cfg, device="cpu")
    return ts, es, m, None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


@pytest.mark.parametrize("case", list(CONFIGS))
def test_inprocess_resume_bit_match(tmp_path, case):
    cfg = _cfg(case)
    ts_s, es_s, opp_s = _init(cfg)
    straight = []
    for _ in range(4):
        ts_s, es_s, m, opp_s = _step(ts_s, es_s, opp_s, cfg)
        straight.append({k: float(v) for k, v in m.items()})
    assert sum(r["episodes"] for r in straight) > 0    # resets in the run

    ts, es, opp = _init(cfg)
    for _ in range(2):
        ts, es, _, opp = _step(ts, es, opp, cfg)
    save_bundle(str(tmp_path / "resume"), ts, es, opp, 2)
    del ts, es, opp

    fresh = _init(cfg, seed=123)[0]             # deliberately another seed
    ts2, es2, opp2, it = restore_bundle(str(tmp_path / "resume"), fresh,
                                        "cpu")
    assert it == 2 and ts2.update_count == 2
    for i in (2, 3):
        ts2, es2, m, opp2 = _step(ts2, es2, opp2, cfg)
        assert {k: float(v) for k, v in m.items()} == straight[i], i

    for a, b in zip(train_state_leaves(ts_s), train_state_leaves(ts2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert torch.equal(ts_s.gen.get_state(), ts2.gen.get_state())
    assert torch.equal(ts_s.host_gen.get_state(), ts2.host_gen.get_state())
    for a, b in zip(_tensors((es_s, opp_s or ())),
                    _tensors((es2, opp2 or ()))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_bundle_refuses_another_world_size_and_another_format(tmp_path):
    cfg = _cfg("simple")
    ts, es, opp = _init(cfg)
    path = str(tmp_path / "resume")
    save_bundle(path, ts, es, opp, 0, gen_states=[
        (ts.gen.get_state(), ts.host_gen.get_state())] * 2)
    with pytest.raises(ValueError, match="2 rank.*this run has 1"):
        restore_bundle(path, ts, "cpu")
    ts2, es2, opp2, it = restore_bundle(path, ts, "cpu", rank=1,
                                        world_size=2)
    assert it == 0 and torch.equal(es2.key, es.key)
    # A weights-only checkpoint is no bundle.
    save_checkpoint(str(tmp_path / "weights"), ts)
    with pytest.raises(ValueError, match="no resume bundle"):
        restore_bundle(str(tmp_path / "weights"), ts, "cpu")


def _run_train(ck, iters, resume=False):
    cmd = [sys.executable, "-m", "pomcpp_tpu_torch.train_ppo", "--batch", "8",
           "--iters", str(iters), "--rollout", "4", "--epochs", "1",
           "--minibatches", "2", "--opponent", "simple", "--learner-slots",
           "0", "--fused", "--device", "cpu", "--ckpt-dir", str(ck),
           "--ckpt-every", "2"] + (["--resume"] if resume else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _rows(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


_TIMING_KEYS = {"env_steps_per_s", "sec"}


def test_cli_resume_bit_match(tmp_path):
    straight = _rows(_run_train(tmp_path / "a", 4))
    part1 = _rows(_run_train(tmp_path / "b", 2))
    out = _run_train(tmp_path / "b", 4, resume=True)
    assert f"resumed full bundle from {tmp_path / 'b' / 'resume'} at iter 2" \
        in out
    part2 = _rows(out)
    assert [r["iter"] for r in part2] == [2, 3]
    resumed = part1 + part2
    assert len(straight) == len(resumed) == 4
    for s, r in zip(straight, resumed):
        for k in s:
            if k not in _TIMING_KEYS:
                assert s[k] == r[k], (s["iter"], k, s[k], r[k])

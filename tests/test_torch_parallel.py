"""Data parallelism of the port (``pomcpp_tpu_torch.parallel``) on the CPU:
two gloo ranks, as two processes, against the same work done unsharded.

This file is also the ranks' program: ``python tests/test_torch_parallel.py
RANK WORLD PORT OUTDIR`` joins a gloo group on ``tcp://localhost:PORT``,
runs every sharded piece on its rows of the global batch, gathers the
results and writes them to ``OUTDIR/rank_RANK.npz``.  The tests hold:

* the sharded env rollout (auto-reset, step cap) and the sharded harmless,
  random and simple chunks (injected moves or rands, injected reset boards,
  auto-reset, ``record=True``) bit for bit against the unsharded call --
  port against port: the JAX package's sharded chunk equals its unsharded
  chunk (``tests/test_parallel.py``), which the port's unsharded chunk
  already equals (``tests/test_torch_chunk.py``, ``test_torch_fsm.py``);
* a 2-rank ``ppo_train_step``: both ranks' parameters, optimizer moments
  and metrics bit-identical;
* the 2-rank summed gradient of one minibatch (shuffle off) against the
  1-rank gradient of the same global minibatch, leaf by leaf: within a
  relative L2 of 1e-5 (the sums run in another order) for the f32 heads,
  within four bf16 unit roundoffs for the bf16 torso (each rank's partial
  weight gradient is rounded to bf16; measured 2.8e-3 against 2.4e-7 for
  the heads), and the loss within 1e-6;
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  pomcpp_tpu_torch.train_ppo --device cpu`` for 2 iterations, its resume
  at the same world size, and its bundle refused at another.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
B, WORLD = 8, 2
ENV_STEPS, ENV_CAP = 24, 10
CHUNK_STEPS = 12
REL_L2 = 1e-5
BF16_REL_L2 = 4 * 2.0 ** -9
F32_LEAVES = ("policy", "value")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env_policy(generator, game, agent_ids):
    """A policy that is a function of the board alone (bombs included), so
    a sharded and an unsharded run take the same moves."""
    del generator
    ids = agent_ids.to(torch.int32)
    return ((game.agent_x * 3 + game.agent_y * 5 + game.timestep[:, None]
             + ids[None]) % 6).to(torch.int32)


def chunk_inputs():
    """Global chunk inputs: boards (two finished, so the first merge resets
    them), injected moves and injected fresh terrain."""
    from pomcpp_tpu_torch.core.board_gen import random_board_fast, \
        random_cell_state

    cs = random_cell_state(B, seed=11, device="cpu")
    dead = cs.agent_dead.clone()
    dead[2, 1:] = dead[5, :3] = True
    cs = cs._replace(agent_dead=dead, alive_count=(4 - dead.sum(1)).int())
    gen = torch.Generator().manual_seed(5)
    moves = torch.randint(0, 6, (CHUNK_STEPS, B, 4), generator=gen,
                          dtype=torch.int32)
    reset = random_board_fast(B, torch.Generator().manual_seed(6))
    return cs, moves, reset


def ppo_cfg(shuffle=True):
    from pomcpp_tpu_torch.learner.ppo import PPOConfig

    return PPOConfig(rollout_len=4, epochs=1, minibatches=2,
                     max_episode_steps=6, opponent="simple",
                     learner_slots=(0,), fused_env=True,
                     shuffle_minibatches=shuffle)


def unsharded_chunk(policy, cs, moves, reset):
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import rollout_chunk

    fsm = simple_fsm_state_init(cs.board.shape[0], "cpu") \
        if policy == "simple" else None
    return rollout_chunk(cs, 3, CHUNK_STEPS, policy, moves=moves,
                         record=True, reset_boards=reset, device="cpu",
                         fsm_state=fsm)


def _flat(prefix, tree, out):
    """Name the tensors of a (nested) tuple of results into ``out``."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.numpy()
        return
    for i, t in enumerate(tree):
        _flat(f"{prefix}.{i}", t, out)


def worker(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner import ppo as tppo
    from pomcpp_tpu_torch.parallel import (
        boards_mesh,
        gather_batch,
        shard_batch,
        shard_env_batch,
        sharded_chunk_rollout,
        sharded_rollout,
    )

    mesh = boards_mesh("gloo", "cpu", f"tcp://localhost:{port}", rank, world)
    out = {}

    # The env rollout of the rank's rows of a global reset.
    es = shard_env_batch(env_reset(21, B, device="cpu"), mesh)
    fin, metrics = sharded_rollout(mesh, env_policy, ENV_STEPS,
                                   max_steps=ENV_CAP)(es)
    _flat("env", gather_batch(fin, mesh), out)
    _flat("env_metrics", gather_batch(tuple(metrics.values()), mesh, axis=1),
          out)

    # The chunks, moves (rands) and reset terrain injected.
    cs, moves, reset = chunk_inputs()
    for policy in ("harmless", "random", "simple"):
        run = sharded_chunk_rollout(mesh, CHUNK_STEPS, policy, record=True)
        fsm = shard_batch(simple_fsm_state_init(B, "cpu"), mesh) \
            if policy == "simple" else None
        res = run(shard_batch(cs, mesh), 3, fsm_state=fsm,
                  moves=shard_batch(moves, mesh, axis=1),
                  reset_boards=shard_batch(reset, mesh))
        res = (res[0], res[1], res[2]) + tuple(res[3:])
        _flat(f"chunk_{policy}", (gather_batch(res[0], mesh),
                                  gather_batch(res[1:3], mesh, axis=1))
              + tuple(gather_batch(r, mesh) for r in res[3:]), out)

    # One data-parallel PPO iteration.
    cfg = ppo_cfg()
    ts = tppo.ppo_init(0, cfg, "cpu", rank=rank)
    es = shard_env_batch(env_reset(1, B, device="cpu"), mesh)
    opp = shard_batch(tppo.opponent_state_init(B, cfg, "cpu"), mesh)
    ts, es, m, opp = tppo.ppo_train_step(ts, es, cfg, opp, device="cpu",
                                         mesh=mesh)
    out.update({f"ppo_param.{k}": v.detach().numpy()
                for k, v in ts.model.state_dict().items()})
    out.update({f"ppo_adam.{i}.{k}": s[k].numpy() for i, s in
                enumerate(ts.optimizer.state.values())
                for k in ("exp_avg", "exp_avg_sq")})
    out.update({f"ppo_metric.{k}": v.numpy() for k, v in m.items()})

    # The summed gradient of one global minibatch, and the 1-rank one.
    cfg = ppo_cfg(shuffle=False)
    ts = tppo.ppo_init(0, cfg, "cpu")
    es = env_reset(1, B, device="cpu")
    _, traj, boot, _ = tppo.collect_rollout_batch(
        ts.model, es, cfg, ts.gen, host_gen=ts.host_gen, device="cpu")
    adv, ret = tppo.compute_gae(traj, boot, cfg)

    def grads(tr, a, r, m):
        flat = tppo.flatten_batch(tr, a, r)
        n = flat[0].shape[0] // cfg.minibatches
        ts.model.zero_grad(set_to_none=True)
        loss, _ = tppo._ppo_loss(ts.model, tuple(x[:n] for x in flat), cfg, m)
        loss.backward()
        params = list(ts.model.parameters())
        tppo.sum_gradients(params, m)
        loss = loss.detach().clone()
        if m is not None:
            torch.distributed.all_reduce(loss)
        return loss, torch.cat([p.grad.reshape(-1) for p in params])

    mine = shard_batch((traj, adv, ret), mesh, axis=1)
    out["grad_loss_dp"], out["grad_dp"] = (t.numpy() for t in grads(*mine,
                                                                     mesh))
    out["grad_loss_one"], out["grad_one"] = (t.numpy() for t in grads(
        traj, adv, ret, None))
    np.savez(os.path.join(outdir, f"rank_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """Run the two ranks once; their result arrays."""
    port, outdir = _free_port(), tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port), outdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    res = []
    for r in range(WORLD):
        with np.load(os.path.join(outdir, f"rank_{r}.npz")) as d:
            res.append({k: d[k] for k in d.files})
    return res


def _expect(ranks, prefix, tree):
    want = {}
    _flat(prefix, tree, want)
    assert want
    for res in ranks:                  # every rank gathered the same
        got = {k: v for k, v in res.items() if k.split(".")[0] == prefix}
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_sharded_env_rollout_matches_unsharded(ranks):
    from pomcpp_tpu_torch.env.environment import env_reset, rollout

    fin, metrics = rollout(env_reset(21, B, device="cpu"), env_policy,
                           ENV_STEPS, max_steps=ENV_CAP, device="cpu")
    assert int(metrics["done"].sum()) >= B     # games end and reset
    assert int(fin.key[:, 2].max()) >= 2
    _expect(ranks, "env", fin)
    _expect(ranks, "env_metrics", tuple(metrics.values()))


@pytest.mark.parametrize("policy", ["harmless", "random", "simple"])
def test_sharded_chunk_matches_unsharded(ranks, policy):
    cs, moves, reset = chunk_inputs()
    res = unsharded_chunk(policy, cs, moves, reset)
    # The two boards that started finished were reset by the chunk.
    assert int(res[0].agent_dead[[2, 5]].sum(1).max()) <= 2
    _expect(ranks, f"chunk_{policy}", (res[0], res[1:3]) + tuple(res[3:]))


def test_two_rank_ppo_step_is_bit_identical_across_ranks(ranks):
    r0, r1 = ranks
    keys = [k for k in r0 if k.startswith("ppo_")]
    assert any(k.startswith("ppo_adam") for k in keys)
    assert {k.split(".")[1] for k in keys if k.startswith("ppo_metric")} == \
        {"loss", "pg_loss", "v_loss", "entropy", "reward_mean", "episodes",
         "draws"}
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
    assert all(np.isfinite(r0[k]).all() for k in keys)


def test_two_rank_summed_gradient_equals_one_rank(ranks):
    """Leaf by leaf.  The heads compute in f32: within ``REL_L2``.  The
    torso computes in bf16 (as flax's ``dtype=bfloat16`` does), so its
    leaves' gradients leave the backward rounded to bf16 -- each rank's
    partial sum on its side, the 1-rank sum once -- and are held within
    ``BF16_REL_L2``, four of bf16's unit roundoffs."""
    from pomcpp_tpu_torch.models.actor_critic import ActorCritic

    leaves = [(n, p.numel()) for n, p in ActorCritic().named_parameters()]
    for res in ranks:
        one, dp = res["grad_one"], res["grad_dp"]
        start = 0
        for name, n in leaves:
            a, b = one[start:start + n], dp[start:start + n]
            start += n
            tol = REL_L2 if name.split(".")[0] in F32_LEAVES else BF16_REL_L2
            assert np.linalg.norm(a) > 0, name
            assert np.linalg.norm(b - a) / np.linalg.norm(a) <= tol, name
        assert start == one.size
        assert abs(float(res["grad_loss_dp"] - res["grad_loss_one"])) <= 1e-6
    assert np.array_equal(ranks[0]["grad_dp"], ranks[1]["grad_dp"])


def test_torchrun_cli_trains_resumes_and_refuses_another_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    ck = tmp_path / "ck"
    args = ["-m", "pomcpp_tpu_torch.train_ppo", "--batch", "8", "--rollout",
            "4", "--epochs", "1", "--opponent", "simple", "--learner-slots",
            "0", "--fused", "--device", "cpu", "--ckpt-dir", str(ck)]

    def torchrun(iters, *extra):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(WORLD), "--master-port",
               str(_free_port())] + args + ["--iters", str(iters), *extra]
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    out = torchrun(2)
    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert "boards mesh over 2 rank(s)" in out
    assert [r["update"] for r in rows] == [1, 2]       # rank 0 prints alone
    out = torchrun(3, "--resume")
    assert f"resumed full bundle from {ck / 'resume'} at iter 2" in out
    assert [json.loads(x)["update"] for x in out.splitlines()
            if x.startswith("{")] == [3]
    one = subprocess.run([sys.executable] + args + ["--iters", "4",
                                                   "--resume"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode != 0
    assert "written by 2 rank(s); this run has 1" in one.stderr


if __name__ == "__main__":
    worker(*map(int, sys.argv[1:4]), sys.argv[4])

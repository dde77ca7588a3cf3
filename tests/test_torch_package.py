"""Package rules of the port: no JAX, explicit devices, lossless conversion."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from pomcpp_tpu.core.board_gen import random_cell_state as jax_random_cell_state
from pomcpp_tpu.core.state import empty_state, plant_bomb, put_agent
from pomcpp_tpu.engine.cellular import from_state
from pomcpp_tpu_torch.convert import diff_fields, to_numpy, to_torch
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.agents.simple import FsmState
from pomcpp_tpu_torch.engine import fused_step as fs
from pomcpp_tpu_torch.engine.fsm import fsm_act, simple_fsm_state_init

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pomcpp_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "pomcpp_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name} imports {bad}"


def test_cpu_step_leaves_jax_unloaded():
    code = (
        "import sys, torch\n"
        "from pomcpp_tpu_torch.core.board_gen import random_cell_state\n"
        "from pomcpp_tpu_torch.engine.fused_step import fused_step, rollout_chunk\n"
        "cs = random_cell_state(4, seed=0, device='cpu')\n"
        "cs = fused_step(cs, torch.zeros((4, 4), dtype=torch.int32), device='cpu')\n"
        "cs = rollout_chunk(cs, 1, 3, 'random', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pomcpp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = random_cell_state(2, seed=0, device="cpu")
    mv = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.fused_step(cs, mv)
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.rollout_chunk(cs, 0, 2, "harmless")
    fsm = simple_fsm_state_init(2, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.rollout_chunk(cs, 0, 2, "simple", fsm_state=fsm)
    with pytest.raises(RuntimeError, match="CUDA"):
        fsm_act(cs, fsm, mv)
    with pytest.raises(RuntimeError, match="CUDA"):
        simple_fsm_state_init(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_cell_state(2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_torch(to_numpy(cs))
    with pytest.raises(RuntimeError, match="CUDA"):
        fs.fused_step(cs, mv, device="cuda")


def test_learner_entry_points_need_cuda(monkeypatch):
    """``ppo_init``, the collector, ``ppo_train_step`` and the training
    script run on the card unless the caller names the CPU."""
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner import PPOConfig, ppo_init, ppo_train_step
    from pomcpp_tpu_torch.learner.ppo import collect_rollout_batch
    from pomcpp_tpu_torch.train_ppo import main as train_main

    cfg = PPOConfig(rollout_len=2, fused_env=True)
    ts = ppo_init(0, cfg, device="cpu")
    es = env_reset(1, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo_init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo_train_step(ts, es, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        collect_rollout_batch(ts.model, es, cfg, ts.gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--batch", "2", "--iters", "1", "--rollout", "2"])
    # A model on the CPU is not run on another device.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model is on cpu"):
        ppo_train_step(ts, es, cfg, device="cuda")
    ts2, _, metrics = ppo_train_step(ts, es, cfg, device="cpu")
    assert ts2.update_count == 1 and set(metrics) >= {"loss", "episodes"}


def test_exact_engine_entry_points_need_cuda(monkeypatch):
    """The exact engine's constructors, the exact env, the exact
    SimpleAgent's state and the census run on the card unless the caller
    names the CPU; the census's ``main`` on the CPU prints its JSON."""
    from pomcpp_tpu_torch import divergence_census
    from pomcpp_tpu_torch.agents.simple import simple_agent_init_batch
    from pomcpp_tpu_torch.core.board_gen import init_state_np, init_states_np
    from pomcpp_tpu_torch.core.state import empty_state as port_empty_state
    from pomcpp_tpu_torch.env.environment import (
        env_reset,
        env_reset_np,
        env_step,
    )

    es = env_reset(1, 2, engine="exact", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: env_reset(1, 2, engine="exact"),
        lambda: env_reset_np(7),
        lambda: init_state_np(7),
        lambda: init_states_np([1, 2]),
        lambda: port_empty_state(2),
        lambda: simple_agent_init_batch(2),
        lambda: env_step(es, torch.zeros((2, 4), dtype=torch.int32)),
        lambda: divergence_census.run_census(2, 2, 2),
        lambda: divergence_census.main(["--games", "2", "--steps", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="engine"):
        env_reset(1, 2, engine="queue", device="cpu")


def test_tooling_entry_points_need_cuda(monkeypatch, tmp_path):
    """The state fuzzer, the demo, the replay viewer's recorder and the
    divergence debugger run on the card unless the caller names the CPU;
    the fuzzer's command line then asserts that the oracle builds."""
    from pomcpp_tpu_torch import (
        debug_divergence,
        play_demo,
        replay_viewer,
        state_fuzz,
    )
    from pomcpp_tpu_torch.testing import oracle

    path = str(tmp_path / "game.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: state_fuzz.fuzz_one(120, 35, 5),
        lambda: state_fuzz.snapshots([120], [35]),
        lambda: state_fuzz.main(["--states", "1"]),
        lambda: play_demo.play_game(0x1337, 2, "random"),
        lambda: play_demo.main(["--steps", "2", "--no-render"]),
        lambda: replay_viewer.record(path, steps=2),
        lambda: replay_viewer.main(["--record", path, "--steps", "2"]),
        lambda: debug_divergence.debug_report(0, 2, 2),
        lambda: debug_divergence.main(["--batch", "2", "--steps", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    if oracle.ensure_oracle() is None:
        with pytest.raises(AssertionError, match="oracle"):
            state_fuzz.main(["--states", "1", "--device", "cpu"])
        with pytest.raises(RuntimeError, match="no oracle"):
            state_fuzz.fuzz_one(120, 35, 5, "cpu")


def test_tooling_mains_run_on_the_cpu(capsys, tmp_path):
    """The demo, the viewer and the debugger on the CPU from their command
    lines: the winner line, the recorded and viewed frames, the report."""
    from pomcpp_tpu_torch import debug_divergence, play_demo, replay_viewer

    assert play_demo.main(["--policy", "random", "--no-render",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith(("Finished!", "Draw!"))
    path = str(tmp_path / "game.npz")
    assert replay_viewer.main(["--record", path, "--steps", "6", "--policy",
                               "harmless", "--device", "cpu"]) == 0
    assert replay_viewer.main(["--view", path, "--frames", "4:9"]) == 0
    out = capsys.readouterr().out
    assert out.count("--- step ") == 3 and "(final state)" in out
    assert debug_divergence.main(["--batch", "8", "--steps", "5",
                                  "--device", "cpu"]) == 0


def test_census_main_runs_on_the_cpu(capsys):
    from pomcpp_tpu_torch import divergence_census

    assert divergence_census.main(["--games", "4", "--steps", "6",
                                   "--batch", "3", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["games"] == 4 and out["unclassified"] == 0
    assert set(out) == {"policy", "games", "steps_cap",
                        "synced_live_board_steps", "first_divergences",
                        "divergence_ppm", "class_counts",
                        "multi_class_steps", "unclassified"}


def test_search_arena_and_distill_entry_points_need_cuda(monkeypatch):
    """The planners, ``az_train_step``, ``play_games`` and the three
    ``python -m`` mains run on the card unless the caller names the CPU."""
    from pomcpp_tpu_torch import arena, evaluate, league, search, train_az
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner import distill

    cs = random_cell_state(2, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cfg = distill.DistillConfig(rollout_len=1, n_sim=2, depth=2,
                                max_tree_depth=2)
    ts = distill.distill_init(0, cfg, "cpu")
    es = env_reset(1, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: search.playout_value(cs, 0, gen, depth=2),
        lambda: search.lookahead_moves(cs, 0, gen, depth=2, n_playouts=2),
        lambda: search.mcts_moves(cs, 0, gen, n_sim=2, depth=2,
                                  max_tree_depth=2),
        lambda: search.mcts_moves_net(cs, 0, ts.model, gen, n_sim=2,
                                      max_tree_depth=2),
        lambda: search.mcts_moves_chunk(cs, 0, gen, n_sim=2, depth=2,
                                        max_tree_depth=2),
        lambda: distill.distill_init(0, cfg),
        lambda: distill.az_train_step(ts, es, cfg),
        lambda: distill.collect_search_rollout(es, cfg, gen),
        lambda: arena.play_games(["random"] * 4, 2, 2),
        lambda: train_az.main(["--batch", "2", "--iters", "1"]),
        lambda: evaluate.main(["--games", "2", "--steps", "2"]),
        lambda: league.main(["--rounds", "1", "--games", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model is on cpu"):
        distill.az_train_step(ts, es, cfg, device="cuda")


def test_chip_smoke_knows_its_phases():
    """``--only=`` takes every held phase, the search, dist, exact and
    tooling phases included."""
    assert set(chip_smoke.HELD_PHASES) == {"step", "fsm", "chunk", "env",
                                           "probes", "learn", "search",
                                           "dist", "exact", "tooling"}


@pytest.mark.parametrize("make", ["empty_cell_state", "simple_agent_init",
                                  "empty_state"])
def test_state_constructors_default_to_the_card(monkeypatch, make):
    """Like every entry point, the state constructors put their state on
    the card unless the caller names the CPU."""
    from pomcpp_tpu_torch.agents.simple import simple_agent_init
    from pomcpp_tpu_torch.core.state import empty_state
    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    fn, args = {"empty_cell_state": (empty_cell_state, (2,)),
                "simple_agent_init": (simple_agent_init, ((2, 4),)),
                "empty_state": (empty_state, (2,))}[make]

    def tensors(x):
        return [x] if isinstance(x, torch.Tensor) else \
            [t for y in x for t in tensors(y)]

    assert all(t.device.type == "cpu" for t in tensors(fn(*args, "cpu")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args)


def test_simple_policy_runs_on_the_cpu():
    cs = random_cell_state(2, seed=0, device="cpu")
    fsm0 = simple_fsm_state_init(2, "cpu")
    out, fsm = fs.rollout_chunk(cs, 0, 3, "simple", fsm_state=fsm0, device="cpu")
    assert (out.timestep == 3).all()
    assert isinstance(fsm, FsmState) and len(fsm) == 10
    for t in fsm:
        assert t.shape == (2, 4) and t.dtype == torch.int32
    assert (fsm.rp_count == 3).all() and (fsm.rp_head == 0).all()


def test_convert_round_trip_is_lossless():
    ref = jax.vmap(jax_random_cell_state)(jax.random.split(jax.random.PRNGKey(2), 6))
    ref = jax.tree.map(np.asarray, ref)
    ref = ref._replace(
        agent_can_kick=np.arange(24).reshape(6, 4) % 3 == 0,
        timestep=np.arange(6, dtype=np.int32) * 1000,
    )
    cs = to_torch(ref, "cpu")
    back = to_numpy(cs)
    assert not diff_fields(ref, back, skip=())
    for name in type(cs)._fields:
        assert getattr(back, name).dtype == getattr(ref, name).dtype, name
        assert getattr(cs, name).dtype == (
            torch.bool if name in ("agent_can_kick", "agent_dead") else torch.int32
        )
    again = to_torch(back, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(cs, again))


def test_smoke_sweep_state_is_the_reference_state():
    """chip_smoke's 6^4-sweep state equals the JAX tests' kick-heavy state."""
    s = empty_state()
    s = put_agent(s, 4, 5, 0)
    s = put_agent(s, 6, 5, 1)
    s = put_agent(s, 5, 4, 2)
    s = put_agent(s, 5, 6, 3)
    s = s._replace(agent_can_kick=jax.numpy.ones((4,), bool))
    s = plant_bomb(s, 5, 5, 0, set_item=True, life=6)
    s = plant_bomb(s, 3, 5, 1, set_item=True, life=9)
    ref = jax.tree.map(lambda x: np.asarray(x)[None], from_state(s))
    assert not diff_fields(ref, chip_smoke.kick_heavy_state("cpu"), skip=())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device, or no package beside the script: non-zero exit and
    no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

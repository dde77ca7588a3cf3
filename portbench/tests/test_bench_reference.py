"""The frozen reference equals the port's plain path on the CPU at a tiny
size, board for board, with boards taken out of their batch."""

import pytest
import torch

from portbench.reference import chunk as ref_chunk
from portbench.reference import env as ref_env
from portbench.reference import rules
from portbench.reference.simple_agent import FsmState

SEED = 2 ** 33 + 977


def _ints(tensors):
    return [t.to(torch.int64) for t in tensors]


@pytest.mark.parametrize("policy,boards,steps", [
    ("harmless", 12, 24), ("random", 24, 48), ("simple", 8, 20)])
def test_chunk_equals_the_port(policy, boards, steps):
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import rollout_chunk

    cs = random_cell_state(boards, 5, device="cpu")
    fsm = simple_fsm_state_init(boards, "cpu") if policy == "simple" else None
    kw = {"fsm_state": fsm} if fsm is not None else {}
    port = rollout_chunk(cs, SEED, steps, policy, device="cpu", **kw)
    port = list(port) if fsm is None else list(port[0]) + list(port[1])
    # Every other board, out of its batch: the draws are keyed by index.
    idx = torch.arange(0, boards, 2)
    sub = rules.CellState(*(t.index_select(0, idx) for t in cs))
    sub_fsm = None if fsm is None else FsmState(
        *(t.index_select(0, idx) for t in fsm))
    ref = ref_chunk.rollout_chunk(sub, torch.full((len(idx),), SEED), idx,
                                  steps, policy, fsm_state=sub_fsm)
    ref = list(ref) if fsm is None else list(ref[0]) + list(ref[1])
    for a, b in zip(_ints(ref), _ints(port)):
        assert torch.equal(a, b.index_select(0, idx))


def test_random_chunk_resets_boards():
    """The comparison above reaches the auto-reset: random play ends games."""
    from pomcpp_tpu_torch.core.board_gen import random_cell_state

    cs = rules.CellState(*random_cell_state(24, 5, device="cpu"))
    out = ref_chunk.rollout_chunk(cs, torch.full((24,), SEED),
                                  torch.arange(24), 48, "random")
    assert bool((out.board != cs.board).any())
    assert int(out.agent_dead.sum()) < int((~cs.agent_dead).sum())


def test_mixed_env_step_equals_the_port():
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.env.environment import (
        env_reset,
        env_step_auto_reset_batch_fsm,
    )

    b = 16
    es = env_reset(SEED, b, device="cpu")
    fsm = simple_fsm_state_init(b, "cpu")
    gen = torch.Generator().manual_seed(3)
    resets = 0
    for t in range(30):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        mv = torch.where(es.game.agent_dead, 0, mv)
        es2, fsm2 = env_step_auto_reset_batch_fsm(
            es, mv, fsm, (0,), 1000 + t, max_steps=12, device="cpu")
        ref_es = ref_env.EnvState(rules.CellState(*es.game), *es[1:])
        r2, rfsm2 = ref_env.mixed_step(ref_es, mv, FsmState(*fsm), (0,),
                                       torch.full((b,), 1000 + t),
                                       torch.arange(b), 12)
        got = list(es2.game) + list(es2[1:]) + list(fsm2)
        want = list(r2.game) + list(r2[1:]) + list(rfsm2)
        for a, w in zip(_ints(got), _ints(want)):
            assert torch.equal(a, w)
        resets += int(es.done.sum())
        es, fsm = es2, fsm2
    assert resets > 0      # the 12-step cap ends games, so resets are held

"""The CUDA kernels vs their plain versions, bit for bit (card only).

These need a CUDA card and ``nvcc``; without a card they skip.  On the
card: ``python -m pytest tests/test_torch_kernels.py -q -m gpu``.
``chip_smoke.py`` runs the same comparisons at the main path's sizes.
"""

import pytest
import torch

import chip_smoke
from pomcpp_tpu_torch import _ext, launch, trace
from pomcpp_tpu_torch.convert import diff_fields
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.engine.fsm import (
    fsm_act,
    fsm_act_plain,
    simple_fsm_state_init,
)
from pomcpp_tpu_torch.engine.fused_step import (
    _to_device,
    fused_step,
    fused_step_plain,
    rollout_chunk,
    rollout_chunk_plain,
)
from pomcpp_tpu_torch import probes
from pomcpp_tpu_torch.env import environment as env
from pomcpp_tpu_torch.models import features

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(cuda, b, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cs = random_cell_state(b, generator=gen)
    kick = torch.rand((b, 4), generator=gen, device=cuda) < 0.5
    return cs._replace(agent_can_kick=kick), gen


def test_step_kernel_matches_plain(cuda):
    cs, gen = _batch(cuda, 512, 1)
    k = p = cs
    for t in range(40):
        mv = torch.randint(0, 6, (512, 4), generator=gen, device=cuda,
                           dtype=torch.int32)
        k = fused_step(k, mv)
        p = fused_step_plain(p, mv)
        assert not diff_fields(k, p, skip=()), f"step {t}"


# One board per warp, four warps per CTA: batches that fill the last CTA,
# leave it ragged (b % 4 != 0) and do not fill one CTA (b < 4).
CHUNK_BATCHES = [256, 1021, 5, 3, 1]


@pytest.mark.parametrize("b", CHUNK_BATCHES)
def test_step_kernel_matches_plain_on_ragged_batches(cuda, b):
    cs, gen = _batch(cuda, b, 10 + b)
    k = p = cs
    for t in range(24):
        mv = torch.randint(0, 6, (b, 4), generator=gen, device=cuda,
                           dtype=torch.int32)
        k = fused_step(k, mv)
        p = fused_step_plain(p, mv)
        assert not diff_fields(k, p, skip=()), f"step {t}"


@pytest.mark.parametrize("b", CHUNK_BATCHES)
@pytest.mark.parametrize("policy", ["harmless", "random"])
def test_chunk_kernel_matches_plain(cuda, policy, b):
    cs, _ = _batch(cuda, b, 2)
    k = rollout_chunk(cs, 7, 48, policy, record=True)
    p = rollout_chunk_plain(cs, 7, 48, policy, record=True)
    assert not diff_fields(k[0], p[0], skip=())
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])


def test_fsm_act_kernel_matches_plain(cuda):
    cs, gen = _batch(cuda, 512, 3)
    fk = fp = simple_fsm_state_init(512, cuda)
    for t in range(30):
        rand = torch.randint(0, 5, (512, 4), generator=gen, device=cuda,
                             dtype=torch.int32)
        mk, fk = fsm_act(cs, fk, rand)
        mp, fp = fsm_act_plain(cs, fp, rand)
        assert torch.equal(mk, mp), f"moves, act {t}"
        assert all(torch.equal(a, b) for a, b in zip(fk, fp)), f"state, act {t}"
        cs = fused_step_plain(cs, torch.where(cs.agent_dead, 0, mp))


@pytest.mark.parametrize("case", sorted(chip_smoke.bfs_need_states("cpu")))
def test_bfs_runs_only_where_a_decision_reads_it(cuda, monkeypatch, case):
    """The crafted boards of ``chip_smoke.bfs_need_states``, 64 copies:
    ``fsm_act_kernel`` and a one-step simple chunk equal their plain
    versions, and the clocked instance counts the acts that ran a BFS round
    and the rounds after each act's first as the need rule says.  On the
    card because ptxas compiles what the host build cannot show."""
    cs, fsm, inject, acts, rounds = chip_smoke.bfs_need_states(cuda)[case]
    b = 64
    cs = chip_smoke.copies(cs, b)
    fsm = type(fsm)(*(t.expand(b, 4).contiguous() for t in fsm))
    gen = torch.Generator(device=cuda).manual_seed(17)
    rand = torch.randint(0, 5, (b, 4), generator=gen, device=cuda,
                         dtype=torch.int32)
    mk, fk = fsm_act(cs, fsm, rand)
    mp, fp = fsm_act_plain(cs, fsm, rand)
    chip_smoke.expect_fsm_equal(f"{case} act", (mk,) + fk, (mp,) + fp)
    kw = dict(record=True, fsm_state=fsm, auto_reset=False,
              moves=torch.randint(0, 6, (1, b, 4), generator=gen, device=cuda,
                                  dtype=torch.int32))
    if inject:
        kw.update(inject_slots=inject, prng_rand=True)
    monkeypatch.setattr(trace, "SAMPLE_EVERY", 1)
    trace.clear()
    trace.enable()
    try:
        k = rollout_chunk(cs, 23, 1, "simple", **kw)
        (row,) = trace.phase_rows()
    finally:
        trace.disable()
        trace.clear()
    p = rollout_chunk_plain(cs, 23, 1, "simple", **kw)
    assert not diff_fields(k[0], p[0], skip=())
    chip_smoke.expect_fsm_equal(f"{case} chunk", k[1:3] + k[3], p[1:3] + p[3])
    assert (row.totals["n_bfs_acts"], row.totals["n_bfs_rounds"]) == \
        (acts * b, rounds * b)


@pytest.mark.parametrize("b", CHUNK_BATCHES)
@pytest.mark.parametrize("inject_slots,prng_rand", [((), False), ((0,), True)])
def test_simple_chunk_kernel_matches_plain(cuda, inject_slots, prng_rand, b):
    cs, gen = _batch(cuda, b, 4)
    fsm = simple_fsm_state_init(b, cuda)
    moves = torch.randint(0, 6, (48, b, 4), generator=gen, device=cuda,
                          dtype=torch.int32) if inject_slots else None
    kw = dict(record=True, fsm_state=fsm, moves=moves,
              inject_slots=inject_slots, prng_rand=prng_rand)
    k = rollout_chunk(cs, 7, 48, "simple", **kw)
    p = rollout_chunk_plain(cs, 7, 48, "simple", **kw)
    assert not diff_fields(k[0], p[0], skip=())
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    assert all(torch.equal(a, b) for a, b in zip(k[3], p[3]))


def _same_env(card, plain, what):
    assert not diff_fields(card.game, plain.game, skip=()), what
    for name in ("done", "winner", "is_draw", "key"):
        assert torch.equal(getattr(card, name).cpu(), getattr(plain, name)), \
            f"{what}: {name}"


@pytest.mark.parametrize("team_mode", [False, True])
def test_fused_env_step_on_the_card_matches_cpu(cuda, team_mode):
    """``env_step_auto_reset_batch(fused=True)``: the step kernel and the
    merge on the card against the plain versions on CPU tensors, the
    port's own Philox resets on both sides."""
    b = 256
    card = plain = env.env_reset(5, b, randomize_positions=True, device="cpu")
    gen = torch.Generator().manual_seed(6)
    for t in range(40):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        kw = dict(fused=True, max_steps=12, team_mode=team_mode,
                  randomize_positions=True)
        card = env.env_step_auto_reset_batch(card, mv, **kw)
        plain = env.env_step_auto_reset_batch(plain, mv, device="cpu", **kw)
        _same_env(card, plain, f"step {t}")
    assert card.done.is_cuda and int(plain.key[:, 2].min()) >= 3


def test_fsm_env_step_on_the_card_matches_cpu(cuda):
    b = 128
    card = plain = env.env_reset(8, b, device="cpu")
    fsm_c = fsm_p = simple_fsm_state_init(b, "cpu")
    gen = torch.Generator().manual_seed(9)
    for t in range(24):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        card, fsm_c = env.env_step_auto_reset_batch_fsm(
            card, mv, fsm_c, (0,), 70 + t, max_steps=10)
        plain, fsm_p = env.env_step_auto_reset_batch_fsm(
            plain, mv, fsm_p, (0,), 70 + t, max_steps=10, device="cpu")
        _same_env(card, plain, f"step {t}")
        assert all(torch.equal(a.cpu(), c) for a, c in zip(fsm_c, fsm_p))


@pytest.mark.parametrize("all_done", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_env_kernels_on_the_card_match_cpu(cuda, inject, all_done):
    """Both env kernels (the fused env step and the merge after the
    one-step simple chunk) in team mode with ``randomize_positions``,
    from some or every board done, with the port's own resets or with
    injected fresh games, against the CPU; each call launches its one
    port kernel and reads nothing back."""
    b = 192
    start = chip_smoke.env_held_start(b, 5, all_done)
    kw = dict(team_mode=True, max_steps=10, randomize_positions=True)
    gen = torch.Generator().manual_seed(7)
    for fsm_path in (False, True):
        plain, card = start, env._env_to_device(start, cuda)
        fsm_p = simple_fsm_state_init(b, "cpu")
        fsm_c = simple_fsm_state_init(b, cuda)
        for t in range(20):
            mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
            fresh = random_cell_state(b, generator=gen,
                                      randomize_positions=True) \
                if inject else None
            # Everything on the card before the call: a copy to the card
            # is a synchronizing call too.
            fresh_c = None if fresh is None else _to_device(fresh, cuda)
            mv_c = mv.to(cuda)
            before = dict(_ext.LAUNCHES)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                if fsm_path:
                    card, fsm_c = env.env_step_auto_reset_batch_fsm(
                        card, mv_c, fsm_c, (0,), 30 + t, fresh=fresh_c, **kw)
                else:
                    card = env.env_step_auto_reset_batch(
                        card, mv_c, fused=True, fresh=fresh_c, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = {"rollout_chunk_simple_kernel", "env_merge_kernel"} \
                if fsm_path else {"fused_env_step_kernel"}
            assert {k for k, v in _ext.LAUNCHES.items()
                    if v == before[k] + 1} == want
            assert sum(_ext.LAUNCHES.values()) == \
                sum(before.values()) + len(want)
            if fsm_path:
                plain, fsm_p = env.env_step_auto_reset_batch_fsm(
                    plain, mv, fsm_p, (0,), 30 + t, fresh=fresh,
                    device="cpu", **kw)
                assert all(torch.equal(a.cpu(), c) for a, c in zip(fsm_c, fsm_p))
            else:
                plain = env.env_step_auto_reset_batch(
                    plain, mv, fused=True, fresh=fresh, device="cpu", **kw)
            _same_env(card, plain, f"fsm={fsm_path} step {t}")


@pytest.mark.parametrize("form,as_is", [("typed", 28), ("int64", 17),
                                        ("host", 17)])
def test_fsm_env_step_typed_path_on_the_card(cuda, form, as_is):
    """The env step's card path (``launch.chunk`` and ``launch.env_merge``)
    from a state on the card, with int32 or int64 moves and FSM arrays on
    the card, or moves as a numpy array and FSM arrays on the host (copied
    to the card): every step equals the plain version on the CPU bit for
    bit (game, env and FSM state), launches exactly one simple chunk and one
    merge, reads nothing back from arrays on the card, and takes ``as_is``
    of its 30 input arrays as they are: its ``wrapper_ops`` are the others'
    conversions and its five output operations."""
    b = 256
    start = chip_smoke.env_held_start(b, 6)
    plain, card = start, env._env_to_device(start, cuda)
    fsm_p = simple_fsm_state_init(b, "cpu")
    fsm_c = simple_fsm_state_init(b, cuda)
    gen = torch.Generator().manual_seed(11)
    for t in range(16):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        mv_c, fsm_in = mv.to(cuda), fsm_c
        if form == "int64":
            mv_c, fsm_in = mv_c.long(), [x.long() for x in fsm_c]
        if form == "host":      # a copy to the card synchronizes
            mv_c, fsm_in = mv.numpy(), [x.cpu() for x in fsm_c]
        before, counts = dict(_ext.LAUNCHES), dict(trace.COUNTERS)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if form != "host" else
                                       "default")
        try:
            card, fsm_c = env.env_step_auto_reset_batch_fsm(
                card, mv_c, fsm_in, (0,), 90 + t, max_steps=10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert {k: v - before[k] for k, v in _ext.LAUNCHES.items()
                if v != before[k]} == {"rollout_chunk_simple_kernel": 1,
                                       "env_merge_kernel": 1}
        assert trace.COUNTERS["wrapper_ops"] - counts["wrapper_ops"] == \
            30 - as_is + 5
        plain, fsm_p = env.env_step_auto_reset_batch_fsm(
            plain, mv, fsm_p, (0,), 90 + t, max_steps=10, device="cpu")
        _same_env(card, plain, f"{form} step {t}")
        assert all(a.is_cuda and a.dtype == c.dtype and
                   torch.equal(a.cpu(), c) for a, c in zip(fsm_c, fsm_p))
    assert card.done.is_cuda and int(plain.key[:, 2].sum()) > b


def test_dot_tc_kernel_is_exact_on_the_held_inputs_at_the_scripts_k(cuda):
    p = next(q for q in probes.PATTERNS if q.op == "dot")
    for seed in (None, 3):
        inputs = probes.pattern_inputs(p, 256, cuda, seed=seed)
        got = probes.run_pattern(p, inputs)
        assert torch.equal(got, probes.run_pattern(p, inputs, plain=True))


def test_dot_tc_kernel_on_random_floats_is_within_its_tolerance(cuda):
    """Random floats, 32 chained products against float64.  Tolerance:
    each product within 2^-15 of |x| @ |w| (TF32 pieces with lo(x) lo(w)
    dropped, 48 f32 accumulations), each ``+ 1.0`` within 2^-24 of the
    result, carried along the chain through |w|; twice that bound covers
    the second-order terms."""
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((256, 128), generator=gen) * 2 - 1
    w = (torch.rand((128, 128), generator=gen) * 2 - 1) / 128
    got = probes.probe_dot(x.to(cuda), w.to(cuda), "dot", 1).cpu().double()
    wa = w.double().abs()
    ref, bound = x.double(), torch.zeros((256, 128), dtype=torch.float64)
    for _ in range(32):
        bound = bound @ wa + 2 ** -15 * (ref.abs() @ wa)
        ref = ref @ w.double() + 1.0
        bound = bound + 2 ** -24 * ref.abs()
    assert bool(((got - ref).abs() <= 2 * bound).all())


@pytest.mark.parametrize("layout", sorted(probes.LAYOUTS))
@pytest.mark.parametrize("p", probes.PATTERNS, ids=probes.label)
def test_probe_kernel_matches_plain(cuda, p, layout):
    inputs = probes.pattern_inputs(p, 256, cuda, seed=3)
    got = probes.run_pattern(p, inputs, k=4, layout=layout)
    want = probes.run_pattern(p, inputs, k=4, plain=True)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_learner_collect_and_update_match_plain(cuda):
    """``chip_smoke.py``'s held learn comparisons at 256 boards: the
    collector on the card equals it on CPU tensors bit for bit but for
    ``logp`` / ``value`` (within ``LEARN_TOL``), and so does one update."""
    err = chip_smoke.phase_learn_held(cuda, {"simple": 256, "selfplay": 256})
    assert all(err[k] <= chip_smoke.LEARN_TOL[k] for k in err)



FEATURE_SLOTS = [(0,), (1, 3), (0, 1, 2, 3)]


@pytest.fixture(scope="module")
def feature_states():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return chip_smoke.feature_states(torch.device("cuda"), 2048, 11)


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("view_range", [4, 2])
@pytest.mark.parametrize("slots", FEATURE_SLOTS, ids=str)
@pytest.mark.parametrize("state", ["reset", "random", "simple", "edges"])
def test_feature_kernel_matches_plain(cuda, feature_states, state, slots,
                                      view_range):
    """``ego_features_kernel`` at 2,048 boards equals the plain version on
    the card bit for bit, into a new block, into a trajectory row and into
    a row that starts off a 16-byte boundary (2,045 boards)."""
    game = feature_states[state]
    want = features.ego_features_plain(game, slots, view_range)
    _ext.reset_launches()
    got = features.ego_features(game, slots, view_range)
    assert _ext.LAUNCHES["ego_features_kernel"] == 1
    assert torch.equal(_bits(got), _bits(want))
    traj = torch.full((3,) + tuple(want.shape), -7.0, dtype=torch.bfloat16,
                      device=cuda)
    features.ego_features(game, slots, view_range, out=traj[1])
    assert torch.equal(_bits(traj[1]), _bits(want))
    assert (traj[0] == -7).all() and (traj[2] == -7).all()
    part = type(game)(*(t[:2045].contiguous() for t in game))
    traj = torch.empty((3, 2045) + tuple(want.shape[1:]), dtype=torch.bfloat16,
                       device=cuda)
    assert traj[1].data_ptr() % 16
    features.ego_features(part, slots, view_range, out=traj[1])
    assert torch.equal(_bits(traj[1]), _bits(want[:2045]))


def test_feature_kernel_divides_as_the_plain_card_path(cuda):
    """The four scalar planes and the six own stats for every integer
    0-1023 equal the card's plain path (``int32 / d`` as a product with the
    float32 reciprocal, rounded to bf16)."""
    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    s = torch.arange(1024, dtype=torch.int32, device=cuda).reshape(256, 4)
    v = torch.arange(256 * 121, dtype=torch.int32, device=cuda)
    g = empty_cell_state(256, cuda)._replace(
        bomb_timer=(v % 1024).reshape(256, 121),
        bomb_strength=((v + 7) % 1024).reshape(256, 121),
        bomb_dir=((v + 13) % 1024).reshape(256, 121),
        flame_timer=((v + 29) % 1024).reshape(256, 121),
        agent_x=s % 11, agent_y=(s // 11) % 11, agent_max_bombs=s,
        agent_bomb_count=s.flip(0), agent_strength=(s + 500) % 1024)
    for r in (4, 10):
        want = features.ego_features_plain(g, (0, 1, 2, 3), r)
        assert torch.equal(_bits(features.ego_features(g, (0, 1, 2, 3), r)),
                           _bits(want))


def _vs_simple_cfg(rollout_len):
    from pomcpp_tpu_torch.learner import ppo as tppo

    return tppo.PPOConfig(rollout_len=rollout_len, epochs=1, minibatches=2,
                          opponent="simple", learner_slots=(0,),
                          fused_env=True, max_episode_steps=800)


def test_collect_takes_the_feature_kernel_in_every_act(cuda):
    """Every act of a collect on the card takes the kernel: its rows equal
    the forward's (``feature_rows == model_rows``) and it launches once an
    act, the bootstrap's included."""
    from pomcpp_tpu_torch.learner import ppo as tppo

    cfg = _vs_simple_cfg(8)
    ts = tppo.ppo_init(5, cfg, device=cuda)
    es = env.env_reset(5, 256, device=cuda)
    _ext.reset_launches()
    before = dict(trace.COUNTERS)
    tppo.collect_rollout_batch(ts.model, es, cfg, ts.gen, host_gen=ts.host_gen,
                               device=cuda)
    rows = {k: trace.COUNTERS[k] - before[k]
            for k in ("feature_rows", "model_rows")}
    assert rows["feature_rows"] == rows["model_rows"] == 9 * 256
    assert _ext.LAUNCHES["ego_features_kernel"] == 9


def test_iteration_features_equal_the_plain_path(cuda, monkeypatch):
    """A whole PPO iteration at the cell's size (2,048 boards x 64 steps,
    against SimpleAgents) writes the same trajectory features as the plain
    path on the card from one seed, bit for bit."""
    from pomcpp_tpu_torch.learner import ppo as tppo

    cfg = _vs_simple_cfg(64)

    card = launch.card

    def plain_features(device, library="kernels"):
        return None if library == "features" else card(device, library)

    def iteration(kernel):
        if not kernel:
            monkeypatch.setattr(launch, "card", plain_features)
        ts = tppo.ppo_init(7, cfg, device=cuda)
        es = env.env_reset(7, 2048, device=cuda)
        rec = {}
        tppo.ppo_train_step(ts, es, cfg, device=cuda, record=rec)
        return rec["traj"]

    got, want = iteration(True), iteration(False)
    assert torch.equal(_bits(got.feats), _bits(want.feats))
    assert torch.equal(got.move, want.move)


def test_search_distill_and_arena_match_plain(cuda):
    """``chip_smoke.py``'s held search comparisons at 64 boards: the chunk
    search (exact ``rollout_chunk_kernel`` launches), the plane engine's
    planners, the unguided collector and an arena line-up on the card equal
    their CPU runs bit for bit; ``mcts_moves_net`` and one update within the
    stated tolerances."""
    res = chip_smoke.phase_search_held(cuda, {"kernel": 64, "plane": 64})
    assert res["mcts_moves_net"]["root_q_err"] <= chip_smoke.NET_Q_TOL
    assert res["update"]["update"] <= chip_smoke.LEARN_TOL["update"]
    assert res["collect"]["launches"]["fused_env_step_kernel"] == \
        chip_smoke.HELD_COLLECT["rollout_len"]

"""The port's tracing (``pomcpp_tpu_torch.trace``) on the CPU: spans at the
entry points' layer boundaries, the counters, and the chunk kernel's
clocked instance through the host build of its source (``csrc/host_emu``,
whose ``clock64()`` reads 0, so only the event counts carry numbers).

The card's wrapper path runs here through the host build: the tests put
the host build's launchers where the plain versions would run, so that an
env step on CPU tensors takes the card's code from its arguments to its
outputs."""

import pytest
import torch

import chip_smoke
from pomcpp_tpu_torch import _ext, launch, trace
from pomcpp_tpu_torch.convert import diff_fields
from pomcpp_tpu_torch.core.board_gen import random_cell_state
from pomcpp_tpu_torch.core.state import empty_state, put_agents_in_corners
from pomcpp_tpu_torch.engine import fused_step as fs
from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
from pomcpp_tpu_torch.engine.step import step as exact_step
from pomcpp_tpu_torch.env import environment as env
from test_torch_csrc import _host_build, host_card

CARD_TREE = {"env.step": ["env.args", "chunk", "merge"],
             "chunk": ["chunk.args", "chunk.launch", "chunk.out"],
             "merge": ["merge.args", "merge.launch"]}
CPU_TREE = {"env.step": ["env.args", "chunk", "merge"],
            "chunk": ["chunk.args", "chunk.launch"]}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return _ext.bind_kernels(_host_build(
        tmp_path_factory, _ext.CSRC / "fused_step.cu", "libhost_trace.so"))


@pytest.fixture
def tracing():
    """Tracing on, from empty records, and off again after the test."""
    trace.clear()
    trace.enable()
    yield trace
    trace.disable()
    trace.clear()


@pytest.fixture
def card_path(host_lib, monkeypatch):
    """The host build in the card's place (``launch.card``): the env step
    and ``rollout_chunk`` on CPU tensors take their card paths.  The
    features keep their plain version unless a test adds its host build to
    the returned libraries."""
    libs = {"kernels": host_lib}
    monkeypatch.setattr(launch, "card", host_card(libs))
    return libs


def _env_steps(n, b=6, seed=3):
    """``n`` mixed-control env steps from one start: the outputs of each."""
    es = env.env_reset(seed, b, device="cpu")
    fsm = simple_fsm_state_init(b, "cpu")
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for k in range(n):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        es, fsm = env.env_step_auto_reset_batch_fsm(
            es, mv, fsm, (0,), 1000 + k, max_steps=800, device="cpu")
        outs.append(list(es.game) + list(es[1:]) + list(fsm))
    return outs


def _tree(records, root):
    """``{name: [child names in time order]}`` below ``root``; every child
    lies inside its parent and carries the parent's id."""
    kids = {}
    for r in records:
        if r.parent_id:
            kids.setdefault(r.parent_id, []).append(r)
    out, todo = {}, [root]
    while todo:
        span = todo.pop()
        below = sorted(kids.get(span.span_id, []), key=lambda r: r.start_ns)
        if below:
            out[span.name] = [c.name for c in below]
        for c in below:
            assert span.start_ns <= c.start_ns <= c.end_ns <= span.end_ns
            assert c.parent_id == span.span_id
        for a, c in zip(below, below[1:]):
            assert a.end_ns <= c.start_ns          # siblings in turn
        todo += below
    return out


@pytest.mark.parametrize("path,tree,counts", [
    ("cpu", CPU_TREE, {}),
    ("card", CARD_TREE, {"wrapper_ops": 7}),
])
def test_env_step_span_tree(request, tracing, path, tree, counts):
    """The span tree of each route, and the counters a step moves: on the
    card path every input array but the two bool agent flags is taken as it
    is (their conversions and the five output operations are the step's
    ``wrapper_ops``)."""
    if path == "card":
        request.getfixturevalue("card_path")
    _env_steps(2)
    records = trace.records()
    roots = [r for r in records if r.parent_id == 0]
    assert [r.name for r in roots] == ["env.step", "env.step"]
    assert all(r.counts == counts for r in roots)
    assert roots[0].span_id != roots[1].span_id
    assert all(_tree(records, r) == tree for r in roots)
    assert len(records) == 2 * (1 + sum(map(len, tree.values())))
    ids = [r.span_id for r in records]
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_tracing_changes_no_output(request, path):
    """Tracing off makes no record; with it on the env steps' outputs are
    the same bit for bit, the eighth step's chunk through the clocked
    instance on the card's path."""
    if path == "card":
        request.getfixturevalue("card_path")
    trace.clear()
    off = _env_steps(9)
    assert trace.records() == [] and trace.phase_rows() == []
    trace.enable()
    try:
        on = _env_steps(9)
    finally:
        trace.disable()
    assert all(torch.equal(a, b) for x, y in zip(off, on) for a, b in zip(x, y))
    assert len(trace.phase_rows()) == (path == "card")
    trace.clear()


def test_a_chunk_alone_is_a_root(tracing, card_path):
    cs = random_cell_state(4, generator=torch.Generator().manual_seed(2))
    fs.rollout_chunk(cs, 5, 3, "harmless", device="cpu")
    records = trace.records()
    (root,) = [r for r in records if r.parent_id == 0]
    assert root.name == "chunk"
    assert _tree(records, root) == {"chunk": CARD_TREE["chunk"]}
    assert root.counts == {"wrapper_ops": 7}   # 2 flags in, 5 ops out


def _calls(host_lib, policy, n, b=3):
    """``n`` host-build chunk calls of 1..n steps, each held to the plain
    chunk -> each call's state in and steps."""
    cs = random_cell_state(b, generator=torch.Generator().manual_seed(9))
    fsm = simple_fsm_state_init(b, "cpu") if policy == "simple" else None
    for k in range(n):
        got = launch.chunk(host_lib, None, cs, 40 + k, k + 1, policy,
                           fsm_state=fsm)
        want = fs.rollout_chunk_plain(cs, 40 + k, k + 1, policy,
                                      fsm_state=fsm)
        if fsm is None:
            got, want = (got,), (want,)
        assert not diff_fields(got[0], want[0], skip=()), k
        for x, y in zip(got[1:] and got[1], want[1:] and want[1]):
            assert torch.equal(x, y), k
        cs, fsm = got[0], (got[1] if fsm is not None else None)


@pytest.mark.parametrize("policy", ["simple", "harmless"])
def test_clocked_instance_matches_plain_and_counts(host_lib, tracing, policy):
    """Calls 8 and 16 of 17 launch the clocked instance; its state and FSM
    state equal the plain chunk's (as every call's do), its event counts are
    its own call's, and the FSM phases stay 0 without the SimpleAgent."""
    b = 3
    _calls(host_lib, policy, 17, b)
    rows = trace.phase_rows()
    assert [r.totals["n_steps"] for r in rows] == [b * 8, b * 16]
    assert all(r.span_id == 0 for r in rows)          # no chunk span open
    for r in rows:
        assert all(r.totals[p] == 0 for p in trace.PHASES[:9])  # clock64() = 0
        if policy == "simple":
            assert r.totals["n_bfs_rounds"] > 0
            assert 0 < r.totals["n_bfs_acts"] <= r.totals["n_steps"]
        else:
            assert r.totals["n_bfs_rounds"] == r.totals["n_bfs_acts"] == 0
            assert all(r.totals[p] == 0
                       for p in ("danger", "bfs", "flee", "decide"))


def test_exactly_every_eighth_call_is_sampled(host_lib):
    """Tracing off samples nothing; ``enable()`` starts the count again."""
    trace.clear()
    _calls(host_lib, "harmless", 9, 2)
    assert trace.phase_rows() == []
    for first in range(2):
        trace.enable()
        _calls(host_lib, "random", 16 + first, 2)
        trace.disable()
    rows = trace.phase_rows()
    trace.clear()
    assert [r.totals["n_steps"] for r in rows] == [2 * 8, 2 * 16] * 2


def _flags_as(cs, dtype):
    return cs._replace(agent_can_kick=cs.agent_can_kick.to(dtype),
                       agent_dead=cs.agent_dead.to(dtype))


@pytest.mark.parametrize("marshal,flags,made", [
    ("kernel_inputs", torch.bool, 2), ("kernel_inputs", torch.int32, 0),
    ("game_arrays", torch.int32, 2), ("game_arrays", torch.bool, 0),
])
def test_wrapper_ops_counts_conversions_alone(marshal, flags, made):
    """A state with bool agent flags takes two conversions to the chunk's
    int32 arrays, and an int32 one two to the env kernels' bytes; an array
    already typed takes none."""
    cs = _flags_as(random_cell_state(2, seed=1, device="cpu"), flags)
    view = launch.STATE_VIEW if marshal == "kernel_inputs" else \
        launch.GAME_VIEW
    before = trace.COUNTERS["wrapper_ops"]
    launch._arrays(view, cs, 2, torch.device("cpu"))
    assert trace.COUNTERS["wrapper_ops"] - before == made


@pytest.mark.parametrize("policy,fsm_dtype", [
    ("harmless", None), ("simple", torch.int32), ("simple", torch.int64)])
def test_wrapper_ops_counts_every_operation_the_chunk_wrapper_enqueues(
        host_lib, policy, fsm_dtype):
    """The counter's increment equals the PyTorch operators (other than
    allocations and views) that the chunk launcher's marshalling and
    outputs dispatch, as a ``TorchDispatchMode`` sees them."""
    cs = random_cell_state(3, seed=4, device="cpu")
    fsm = None if fsm_dtype is None else \
        [t.to(fsm_dtype) for t in simple_fsm_state_init(3, "cpu")]
    before = trace.COUNTERS["wrapper_ops"]
    ops = chip_smoke.device_ops(lambda: launch.chunk(
        host_lib, None, cs, 7, 2, policy, fsm_state=fsm))
    assert trace.COUNTERS["wrapper_ops"] - before == len(ops) == \
        7 + (10 if fsm_dtype is torch.int64 else 0)


def test_counters_are_always_on_and_launches_are_the_tracers():
    assert not trace.enabled()
    assert _ext.LAUNCHES is trace.LAUNCHES
    assert set(_ext.KERNELS) == set(trace.LAUNCHES)
    assert all(k.startswith("rollout_chunk") for k in _ext.KERNELS
               if "clocked" in k)
    s = put_agents_in_corners(empty_state(1, "cpu"), 0, 1, 2, 3)
    before = trace.COUNTERS["host_reads"]
    exact_step(s, torch.zeros((1, 4), dtype=torch.int32))
    assert trace.COUNTERS["host_reads"] > before
    assert trace.records() == []


def test_records_are_bounded_and_an_error_closes_its_spans(tracing,
                                                           monkeypatch):
    monkeypatch.setattr(trace, "_records",
                        trace.collections.deque(maxlen=5))
    for _ in range(4):
        span = trace.begin("chunk")
        trace.phase("chunk.args")
        trace.end(span)
    assert [r.name for r in trace.records()] == ["chunk", "chunk.args",
                                                 "chunk"] + ["chunk.args",
                                                             "chunk"]
    with pytest.raises(ValueError, match="unknown policy"):
        fs.rollout_chunk(random_cell_state(1, seed=0, device="cpu"), 1, 1, "nope",
                         device="cpu")
    assert trace._open == []
    assert trace.records()[-1].name == "chunk"


PPO_STEPS, PPO_BOARDS, PPO_EPOCHS = 3, 4, 2
PPO_TREE = {"ppo.step": ["ppo.collect", "ppo.gae", "ppo.update"],
            "ppo.collect": ["ppo.act", "env.step"] * PPO_STEPS + ["ppo.act"],
            "ppo.act": ["ppo.features"], **CPU_TREE}


def _ppo_iteration():
    """One PPO iteration of the flagship's shape on the CPU: learner slot 0
    against three SimpleAgents on the mixed-control step."""
    from pomcpp_tpu_torch.learner import ppo

    cfg = ppo.PPOConfig(rollout_len=PPO_STEPS, epochs=PPO_EPOCHS,
                        minibatches=2, opponent="simple", learner_slots=(0,),
                        fused_env=True)
    ts = ppo.ppo_init(4, cfg, "cpu")
    es = env.env_reset(4, PPO_BOARDS, device="cpu")
    opp = ppo.opponent_state_init(PPO_BOARDS, cfg, "cpu")
    ppo.ppo_train_step(ts, es, cfg, opp, device="cpu")


# Rows through the forward in collect (a rollout step's and the bootstrap
# value's) and through the update (each epoch again).
PPO_COUNTS = {"model_rows": PPO_BOARDS * (PPO_STEPS + 1),
              "update_rows": PPO_BOARDS * PPO_STEPS * PPO_EPOCHS}


def test_ppo_train_step_span_tree(tracing):
    """The learner's spans: ``ppo.step`` over collect, GAE and update, each
    rollout step's ``ppo.act`` (its features in ``ppo.features``) and
    ``env.step`` inside ``ppo.collect`` with the env step's own tree below
    it; the root's counts are the row counters' exact increments."""
    _ppo_iteration()
    records = trace.records()
    roots = [r for r in records if r.parent_id == 0]
    assert [r.name for r in roots] == ["ppo.step"]
    assert _tree(records, roots[0]) == PPO_TREE
    assert roots[0].counts == PPO_COUNTS


@pytest.fixture(scope="module")
def features_host_lib(tmp_path_factory):
    return _ext.bind_features(_host_build(
        tmp_path_factory, _ext.CSRC / "features.cu", "libfeatures_trace.so"))


def test_ppo_step_counts_every_act_as_feature_rows_on_the_card_path(
        tracing, card_path, features_host_lib):
    """With the card's launchers in place (the host builds), every act's
    features take the feature kernel: the ``ppo.step`` root counts as many
    feature rows as rows through the forward, and ``ppo.features`` sits in
    each ``ppo.act``."""
    card_path["features"] = features_host_lib
    _ppo_iteration()
    records = trace.records()
    roots = [r for r in records if r.parent_id == 0]
    assert [r.name for r in roots] == ["ppo.step"]
    assert roots[0].counts["feature_rows"] == roots[0].counts["model_rows"] \
        == PPO_COUNTS["model_rows"]
    assert _tree(records, roots[0]) == {**PPO_TREE, **CARD_TREE}


def test_ppo_tracing_off_records_nothing_and_still_counts():
    trace.clear()
    before = dict(trace.COUNTERS)
    _ppo_iteration()
    assert trace.records() == []
    assert {k: trace.COUNTERS[k] - before[k] for k in PPO_COUNTS} == PPO_COUNTS

"""The readers of the program's own spans, counters and phase clocks
(``portbench/program_trace.py``) on synthetic records, and on the card that
the program's spans and the device trace share one clock."""

import pytest

from portbench import catalog, program_trace, run
from portbench.drivers.common import Record
from pomcpp_tpu_torch.trace import PHASES, PhaseRow, Span

NEW = ["marshal_ms.envloop", "launch_ms.envloop",
       "wrapper_ops_per_step.envloop", "bfs_rounds_per_step.selfplay"] + \
    [f"phase_pct.{p}" for p in PHASES[:9]]
MS = 1_000_000


class _Program:
    def __init__(self, records, rows=()):
        self._records, self._rows = list(records), list(rows)

    def records(self):
        return self._records

    def phase_rows(self):
        return self._rows


def _env_step(sid, start_ms, wrapper_ops=7):
    """The records of one ``env.step`` at ``start_ms``, children first as the
    program records them: 1 ms of arguments, a chunk of 3 ms (1 of it the
    launch), a merge of 2 ms (0.5 of it the launch)."""
    t = start_ms * MS
    kids = [  # name, id, parent id (offsets from sid), start, end (ms)
        ("env.args", 1, 0, 0, 1), ("chunk.args", 3, 2, 1, 1.5),
        ("chunk.launch", 4, 2, 1.5, 2.5), ("chunk.out", 5, 2, 2.5, 4),
        ("chunk", 2, 0, 1, 4), ("merge.args", 7, 6, 4, 5.5),
        ("merge.launch", 8, 6, 5.5, 6), ("merge", 6, 0, 4, 6)]
    out = [Span(n, sid + i, sid + p, int(t + a * MS), int(t + b * MS), {})
           for n, i, p, a, b in kids]
    return out + [Span("env.step", sid, 0, t, int(t + 6 * MS),
                       {"wrapper_ops": wrapper_ops})]


def _rec(start_s=1.0, window_s=1.0):
    return Record(first_call=start_s, window_s=window_s, wall_offset=100.0)


@pytest.fixture
def program(monkeypatch):
    def use(records, rows=()):
        monkeypatch.setattr(program_trace, "_trace", _Program(records, rows))
        monkeypatch.setattr(program_trace, "_last", (None, None))
    return use


def _read(name, rec):
    return catalog.reader(name).read(rec, name)


LEAVES = ["env.args", "chunk.args", "chunk.launch", "chunk.out", "merge.args",
          "merge.launch"]


def _busy_but(rec, records, skip=()):
    """Device operations over the whole window but for a 20 us gap in the
    middle of each innermost span (``skip``: by index in ``records``)."""
    parents = {r.parent_id for r in records}
    mids = sorted((r.start_ns + r.end_ns) / 2e9 + rec.wall_offset
                  for k, r in enumerate(records)
                  if r.parent_id and r.span_id not in parents and k not in skip)
    t, ops = rec.first_call + rec.wall_offset, []
    for m in mids:
        ops.append(("k", t, m - 1e-5))
        t = m + 1e-5
    rec.ops = ops + [("k", t, rec.first_call + rec.window_s + rec.wall_offset)]


def test_env_readers_take_the_window_alone(program):
    """Two steps inside the window and one on each side of it, which read
    otherwise: only the two inside count."""
    records = (_env_step(100, 900, wrapper_ops=50) + _env_step(200, 1100) +
               _env_step(300, 1500) + _env_step(400, 1997, wrapper_ops=50))
    program(records)
    rec = _rec()
    assert _read("marshal_ms.envloop", rec) == pytest.approx(4.5)
    assert _read("launch_ms.envloop", rec) == pytest.approx(1.5)
    assert _read("wrapper_ops_per_step.envloop", rec) == 7
    assert rec.spans == []                   # no device trace: none laid


def test_gap_spans_name_the_idle_time_inside_the_window(program, monkeypatch):
    """The innermost spans that hold an idle gap join the benchmark's on the
    wall clock, and the breakdown names the gaps by them; one without a
    gap, and every span outside the window, stays out; over the checks'
    budget every k-th step's spans alone."""
    records = (_env_step(100, 900) + _env_step(200, 1100) +
               _env_step(300, 1500) + _env_step(400, 1997))
    program(records)
    rec = _rec()
    out = [k for k, r in enumerate(records) if r.name == "chunk.out"]
    _busy_but(rec, records, skip=out[1:2])    # no gap in step 200's chunk.out
    rec.span("env.call", 1.5, 1.506)          # the benchmark's own, kept
    assert _read("marshal_ms.envloop", rec) == pytest.approx(4.5)
    names = [s[0] for s in rec.spans]         # laid out in time order
    assert names == LEAVES[:3] + LEAVES[4:] + ["env.call"] + LEAVES
    assert rec.spans[0][1] == pytest.approx(1.1 + 100.0)
    assert rec.spans[5][1:] == (1.5 + 100.0, 1.506 + 100.0)
    _read("launch_ms.envloop", rec)           # read once, appended once
    assert len(rec.spans) == 12
    gaps = dict(run.breakdown(rec)["idle_gaps"])
    assert set(gaps) == set(LEAVES) | {"host:other"}   # env.call: its leaves
    assert gaps["chunk.out"] == pytest.approx(2e-5)

    monkeypatch.setattr(program_trace, "LABEL_CHECKS", 1)   # stride: all
    monkeypatch.setattr(program_trace, "_last", (None, None))
    rec2 = _rec()
    rec2.ops = rec.ops
    _read("launch_ms.envloop", rec2)
    assert [s[0] for s in rec2.spans] == LEAVES[:3] + LEAVES[4:]


@pytest.mark.parametrize("name", NEW)
def test_no_records_read_none(program, name):
    program([])
    assert _read(name, _rec()) is None


def test_a_program_without_tracing_reads_none(monkeypatch):
    monkeypatch.setattr(program_trace, "_trace", None)
    monkeypatch.setattr(program_trace, "_last", (None, None))
    rec = _rec()
    assert all(_read(n, rec) is None for n in NEW)
    assert rec.spans == []


def _chunk(sid, start_ms):
    t = start_ms * MS
    return [Span("chunk.args", sid + 1, sid, t, t + MS, {}),
            Span("chunk.launch", sid + 2, sid, t + MS, t + 2 * MS, {}),
            Span("chunk.out", sid + 3, sid, t + 2 * MS, t + 3 * MS, {}),
            Span("chunk", sid, 0, t, t + 3 * MS, {})]


def _totals(scale, fsm=True):
    cycles = dict(zip(PHASES[:9], (4, 3, 9, 2, 5, 7, 1, 6, 3)))
    if not fsm:
        cycles.update(danger=0, bfs=0, flee=0, decide=0)
    counts = {"n_bfs_rounds": 40 * fsm, "n_bomb_steps": 5, "n_move_passes": 3,
              "n_blasts": 1, "n_steps": 10}
    return {k: v * scale for k, v in {**cycles, **counts}.items()}


@pytest.mark.parametrize("policy,phases", [
    ("simple", PHASES[:9]), ("harmless", ("draw", "move", "bombs", "blast",
                                          "rest"))])
def test_phase_shares_sum_to_100_over_the_window(program, policy, phases):
    """The splits a cell lists sum to 100; a sampled call outside the
    window (its ``chunk`` span) is left out."""
    fsm = policy == "simple"
    records = _chunk(10, 500) + _chunk(20, 1200) + _chunk(30, 1600)
    rows = [PhaseRow(10, _totals(1000, fsm)), PhaseRow(20, _totals(1, fsm)),
            PhaseRow(30, _totals(3, fsm))]
    program(records, rows)
    rec = _rec()
    shares = {p: _read(f"phase_pct.{p}", rec) for p in phases}
    assert sum(shares.values()) == pytest.approx(100.0)
    assert shares["move"] == pytest.approx(100.0 * 7 / (40 if fsm else 21))
    bfs = _read("bfs_rounds_per_step.selfplay", rec)
    assert bfs == (4.0 if fsm else 0.0)


def test_every_new_metric_has_a_reader_in_its_cells():
    bench = catalog.load()
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    assert set(NEW) <= set(listed)
    for name in NEW:
        for cell in listed[name]:
            assert name in catalog.resolve(cell)["readers"]
        assert catalog.reader(name).__name__.startswith("portbench.metrics.")


@pytest.mark.gpu
def test_program_spans_and_device_trace_share_a_clock(card):
    """In a traced window of the env cell, every ``chunk.launch`` span
    starts before its ``rollout_chunk*`` kernel starts in the device trace,
    and the kernel starts within 50 ms of it."""
    from pomcpp_tpu_torch import trace

    from portbench import run
    from portbench.drivers.common import Context

    r = catalog.resolve("env.mixed_step")
    ctx = Context(r["config"], r["traffic"], 2 ** 31 + 11, 1.0, card)
    trace.clear()
    trace.enable()
    rec, checks, _ = run.measure(ctx, r["traffic"], trace=True)
    assert run.correct(checks)
    win = program_trace.window(rec, trace.records(), [])
    launches = [k for _, kids in win.roots for k in kids
                if k.name == "chunk.launch"]
    kernels = sorted(s for n, s, _ in rec.ops if n.startswith("rollout_chunk"))
    assert len(launches) == len(kernels) == rec.calls > 10
    for span, start in zip(launches, kernels):
        at = span.start_ns * 1e-9 + rec.wall_offset
        assert at <= start <= at + 0.05, (at, start)

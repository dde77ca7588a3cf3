"""The reader of ``bfs_act_share.selfplay`` (``portbench/metrics/
bfs_act_share.py``) on synthetic phase rows: the share of board-steps whose
SimpleAgent act ran a BFS round, or nothing where the rows lack the count."""

import pytest

from portbench import catalog, program_trace
from portbench.tests.test_bench_program_trace import (  # noqa: F401
    _chunk, _read, _rec, _totals, program)
from pomcpp_tpu_torch.trace import PhaseRow

NAME = "bfs_act_share.selfplay"


@pytest.mark.parametrize("counted", [True, False])
def test_bfs_act_share_reads_the_count_or_nothing(program, counted):
    """``n_bfs_acts`` over ``n_steps`` of the window's sampled calls (the
    call at 500 ms lies outside it); the rows of a program that does not
    count those acts read nothing."""
    records = _chunk(10, 500) + _chunk(20, 1200) + _chunk(30, 1600)
    rows = []
    for sid, scale in ((10, 1000), (20, 1), (30, 3)):
        totals = _totals(scale)
        if counted:
            totals["n_bfs_acts"] = 6 * scale
        rows.append(PhaseRow(sid, totals))
    program(records, rows)
    share = _read(NAME, _rec())
    assert share == (pytest.approx(0.6) if counted else None)


def test_bfs_act_share_reads_none_without_records_or_tracing(program,
                                                             monkeypatch):
    program([])
    assert _read(NAME, _rec()) is None
    monkeypatch.setattr(program_trace, "_trace", None)
    monkeypatch.setattr(program_trace, "_last", (None, None))
    assert _read(NAME, _rec()) is None


def test_bfs_act_share_has_a_reader_in_its_cells():
    listed = {m["name"]: m for m in catalog.load()["per_layer"]}
    assert listed[NAME]["workloads"] == ["ffa.simple_chunk"]
    assert NAME in catalog.resolve("ffa.simple_chunk")["readers"]
    assert catalog.reader(NAME).__name__ == "portbench.metrics.bfs_act_share"

"""The ``ppo.vs_simple`` cell on the CPU, where the port's entry points run
their plain versions: the ``train`` driver through the harness's own
check (``run.measure``) at a size a test run holds, the cell found by
name, three faults planted in the timed path, each of which must read not
correct, and the cell's readers on synthetic records."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import catalog, control_train, program_trace, run
from portbench.drivers import train
from portbench.drivers.common import Context, Record
from portbench.metrics import train_mfu_pct
from portbench.peaks import Rates
from pomcpp_tpu_torch.learner import ppo
from pomcpp_tpu_torch.trace import Span

CPU = torch.device("cpu")
CELL = "ppo.vs_simple"
READERS = ["collect_ms.train", "act_ms.train", "update_ms.train",
           "train_mfu_pct", "device_idle_pct.train",
           "launches_per_step.train"]


def _ctx(seed=2 ** 31 + 5, boards=16, steps=8, calls=3):
    r = catalog.resolve(CELL)
    tr = dict(r["traffic"], steps=steps, warmup_calls=1)
    tr["check"] = dict(tr["check"], calls=2, boards=boards)
    return Context(dict(r["config"], boards=boards), tr, seed, 0.0, CPU,
                   calls=calls)


def _correct(ctx):
    rec, checks, _ = run.measure(ctx, ctx.traffic)
    return rec, {n: v for n, v, _ in checks}, run.correct(checks)


def test_the_cell_resolves_by_name():
    r = catalog.resolve(CELL)
    assert r["config"]["name"] == "ppo_ac128"
    assert r["config"]["boards"] == 2048 and r["traffic"]["steps"] == 64
    assert r["driver"] == "portbench.drivers.train"
    assert {n: r["readers"][n] for n in READERS} == {
        n: f"portbench.metrics.{n.split('.')[0]}" for n in READERS}
    assert set(r["readers"]) == set(READERS) | {"setup_s",
                                                "envloop_steps_per_s"}


def test_the_configuration_is_the_flagship_recipe():
    """The configuration's learner settings and widths are what
    ``ppo_init`` builds and ``chip_smoke.flagship_cfg`` runs."""
    import chip_smoke

    ctx = _ctx()
    ctx.traffic["steps"] = 64
    assert train.ppo_config(ctx) == chip_smoke.flagship_cfg()
    model = ppo.ppo_init(0, train.ppo_config(ctx), "cpu").model
    assert sum(p.numel() for p in model.parameters()) == \
        ctx.config["model"]["parameters"] == 714823
    fwd, both = train_mfu_pct.ops_per_row(ctx.config["model"])
    assert (fwd, both) == (9447040, chip_smoke.update_flop_per_row(model))


def test_a_sound_run_is_correct_and_counts_rollout_steps():
    ctx = _ctx()
    rec, checks, ok = _correct(ctx)
    assert ok, checks
    assert rec.calls == 3 * 8 and rec.work == 3 * 8 * 16
    assert checks["mismatched_values"] == checks["moves_mismatched"] == 0
    assert checks["iterations_checked"] == 2 and rec.failed == 0


def _altered_move(base):
    def call(ts, es, opp, record):
        out = base(ts, es, opp, record)
        if record is None:          # a warm-up iteration
            return out
        traj = record["traj"]
        t, b, slot = traj.alive.nonzero()[0].tolist()
        traj.move[t, b, slot] = (traj.move[t, b, slot] + 1) % 6
        return out
    return call


@pytest.mark.parametrize("fault", ["skipped_update", "half_batch",
                                   "altered_move"])
def test_fault_is_caught(fault):
    ctx = _ctx()
    ctx.program = (_altered_move(train.port_program(ctx))
                   if fault == "altered_move"
                   else control_train.PROGRAMS[fault](ctx))
    _, checks, ok = _correct(ctx)
    assert not ok, checks


class _Program:
    def __init__(self, records):
        self._records = records

    def records(self):
        return self._records

    def phase_rows(self):
        return []


MS = 1_000_000


def _iteration(sid, start_ms):
    """One ``ppo.step`` at ``start_ms``, children first as the program
    records them: a collect of 100 ms with two acts of 2 and 4 ms, GAE,
    and an update from 105 to 115 ms."""
    t = start_ms * MS
    kids = [("ppo.act", 2, 1, 0, 2), ("ppo.act", 3, 1, 50, 54),
            ("ppo.collect", 1, 0, 0, 100), ("ppo.gae", 4, 0, 100, 105),
            ("ppo.update", 5, 0, 105, 115)]
    out = [Span(n, sid + i, sid + p, int(t + a * MS), int(t + b * MS), {})
           for n, i, p, a, b in kids]
    return out + [Span("ppo.step", sid, 0, t, int(t + 115 * MS),
                       {"model_rows": 2048 * 65, "update_rows": 131072})]


def test_readers_on_a_synthetic_record(monkeypatch):
    """Two iterations inside a 1 s window (each fetch ending 40 ms after
    its ``ppo.step``) and one outside it."""
    rec = Record(first_call=1.0, window_s=1.0, wall_offset=100.0,
                 rates=Rates(132, 1980.0, 128 * 132 * 1980e6),
                 roofline={"model": catalog.resolve(CELL)["config"]["model"]})
    records = _iteration(10, 1100) + _iteration(20, 1500) + \
        _iteration(30, 2500)
    for start in (1100, 1500):
        end = (start + 115 + 40) / 1e3
        rec.span("train.fetch", end - 0.04, end)
    monkeypatch.setattr(program_trace, "_trace", _Program(records))
    monkeypatch.setattr(program_trace, "_last", (None, None))

    def read(name):
        return catalog.reader(name).read(rec, name)

    assert read("collect_ms.train") == pytest.approx(100.0)
    assert read("act_ms.train") == pytest.approx(3.0)
    assert read("update_ms.train") == pytest.approx(50.0)
    ops = 2 * (2048 * 65 * 9447040 + 131072 * 26194944)
    assert read("train_mfu_pct") == pytest.approx(
        100 * ops / 1.0 / (4096 * 132 * 1980e6))
    monkeypatch.setattr(program_trace, "_trace", _Program([]))
    monkeypatch.setattr(program_trace, "_last", (None, None))
    assert all(read(n) is None for n in READERS)


def test_the_bf16_peak_of_an_h100():
    rates = Rates(132, 1980.0, 128 * 132 * 1980e6)
    assert train_mfu_pct.peak(rates) == pytest.approx(1.0705e15, rel=1e-4)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys, portbench.reference.ppo\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "pomcpp_tpu",
                         "pomcpp_tpu_torch"}

"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: the harness's own check (``run.measure``) drives a
window on the CPU, where the port's entry points run their plain
versions, at a size a test run holds.  The faults a cell can have on one
chip: a call that returns its state unchanged, half of the batch left out
(not stepped), an answer altered where it is produced; and the control
(the reference with the movement chain cut to one round) in the port's
place."""

import pytest
import torch

from portbench import catalog, run
from portbench.drivers.common import Context

CPU = torch.device("cpu")
SIZES = {  # boards, steps a chunk, calls, calls checked, boards checked
    "ffa.simple_chunk": (8, 8, 3, 2, 8),
    "ffa.harmless_chunk": (16, 16, 3, 2, 16),
    "env.mixed_step": (16, 1, 8, 3, 16),
}


def _ctx(workload, seed=2 ** 31 + 5, sizes=None):
    boards, steps, calls, checked, per = sizes or SIZES[workload]
    r = catalog.resolve(workload)
    tr = dict(r["traffic"])
    if "steps" in tr:
        tr["steps"] = steps
    tr["check"] = dict(tr["check"], calls=checked, boards=per)
    ctx = Context(dict(r["config"], boards=boards), tr, seed, 0.0, CPU,
                  calls=calls)
    return ctx, catalog.driver(tr)


def _correct(ctx):
    _, checks, _ = run.measure(ctx, ctx.traffic)
    return run.correct(checks)


def _halves(new, old):
    """The first half of the boards from ``new``, the rest from ``old``."""
    h = old[0].shape[0] // 2
    return type(new)(*(torch.cat([n[:h], o[h:]]) for n, o in zip(new, old)))


def _altered(game):
    """Every board's cell 60 changed by one."""
    return game._replace(board=game.board + (torch.arange(121) == 60))


def _chunk_fault(kind, base):
    def call(cs, seed, fsm):
        if kind == "unchanged":
            return cs, fsm
        out, fsm_out = base(cs, seed, fsm)
        if kind == "half":
            return _halves(out, cs), fsm_out if fsm is None else \
                _halves(fsm_out, fsm)
        return _altered(out), fsm_out
    return call


def _env_fault(kind, base):
    def call(es, moves, fsm, seed):
        if kind == "unchanged":
            return es, fsm
        es2, fsm2 = base(es, moves, fsm, seed)
        if kind == "half":
            game = _halves(es2.game, es.game)
            rest = [torch.cat([n[:len(n) // 2], o[len(n) // 2:]])
                    for n, o in zip(es2[1:], es[1:])]
            return type(es2)(game, *rest), _halves(fsm2, fsm)
        return es2._replace(game=_altered(es2.game)), fsm2
    return call


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_sound_run_is_correct(workload):
    ctx, _ = _ctx(workload)
    assert _correct(ctx)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_fault_is_caught(workload, kind):
    ctx, mod = _ctx(workload)
    wrap = _env_fault if workload.startswith("env.") else _chunk_fault
    ctx.program = wrap(kind, mod.port_program(ctx))
    assert not _correct(ctx)


def test_control_is_not_correct():
    """At 32 boards x 64 steps the cut movement chain shows on every seed
    tried; on the card it runs at the cells' own sizes
    (``python3 -m portbench.control``)."""
    for seed in (5, 6, 7):
        ctx, mod = _ctx("ffa.harmless_chunk", seed, (32, 64, 2, 2, 32))
        ctx.program = mod.control(ctx)
        assert not _correct(ctx)

"""On the card: the ``ppo.vs_simple`` cell through the command line in both
trace modes with the result line the contract asks for, and at the cell's
own size its control (the torso through float8_e4m3fn) and the update blind
to half the batch not correct.
``python3 -m pytest portbench/tests -q -m gpu``."""

import json
import subprocess
import sys

import pytest

from portbench import catalog

pytestmark = pytest.mark.gpu
CELL = "ppo.vs_simple"


@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell_runs(card, trace):
    bench = catalog.load()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"]
            for m in catalog.metrics_for(bench, CELL, kind)}
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", CELL, "--seed",
         str(2 ** 31 + 19), "--seconds", "3", "--trace", str(trace)],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 64 == 0
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert res["checks"]["kernel_launches_short"]["value"] == 0
    if trace:
        assert 0 < res["metrics"]["train_mfu_pct"]["value"] < 100


@pytest.mark.parametrize("program", ["fp8", "half_batch"])
def test_train_control_on_the_card(card, program):
    from portbench.control_train import control_run

    row = control_run(2 ** 31 + 23, 2, card, program)
    assert not row["correct"], row["checks"]

"""On the card: every cell runs through the command line in both trace
modes with the result line the contract asks for, and the control comes
out not correct.  ``python3 -m pytest portbench/tests -q -m gpu``."""

import json
import subprocess
import sys

import pytest

from portbench import catalog

pytestmark = pytest.mark.gpu


def _run(args):
    out = subprocess.run([sys.executable, "-m", "portbench", *args],
                         cwd=catalog.ROOT, capture_output=True, text=True,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["ffa.simple_chunk", "env.mixed_step",
                                      "ffa.harmless_chunk"])
def test_cell_runs(card, workload, trace):
    bench = catalog.load()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"]
            for m in catalog.metrics_for(bench, workload, kind)}
    res, err = _run(["--workload", workload, "--seed", str(2 ** 31 + 17),
                     "--seconds", "2", "--trace", str(trace)])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"] * 1.01
        assert res["breakdown"]["device_ops"]
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


def test_control_on_the_card(card):
    from portbench.control import control_run

    row = control_run("ffa.harmless_chunk", 2 ** 31 + 3, 1, card)
    assert not row["correct"]

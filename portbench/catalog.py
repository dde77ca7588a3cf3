"""Find a cell's configuration, traffic mix, driver and metric readers by
the names in ``BENCHMARK.json``: adding any of them is adding files and
entries, never editing one."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, cell_: dict, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell_["config"]:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict) -> dict:
    with open(PACKAGE / "traffic" / f"{cell_['traffic']}.json") as f:
        return json.load(f)


def driver(traffic_: dict):
    return importlib.import_module(f"portbench.drivers.{traffic_['driver']}")


def metrics_for(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports:
    those whose ``workloads`` list it, and those with no such list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", (cell_name,))]


def reader(metric_name: str):
    """``metrics/<name>.py``, or for a split ``<name>.<part>`` the reader of
    ``<name>`` when the split has no file of its own."""
    for mod in (metric_name.replace(".", "__"), metric_name.split(".")[0]):
        if (PACKAGE / "metrics" / f"{mod}.py").exists():
            return importlib.import_module(f"portbench.metrics.{mod}")
    raise KeyError(f"no reader for metric {metric_name!r} in "
                   f"{PACKAGE / 'metrics'}")


def resolve(workload: str, root: Path = ROOT) -> dict:
    """Every file a cell is run from, found by name (what the tests hold)."""
    bench = load(root)
    c = cell(bench, workload)
    t = traffic(c)
    names = [m["name"] for kind in ("end_to_end", "per_layer")
             for m in metrics_for(bench, workload, kind)]
    return {
        "config": config(bench, c, root),
        "traffic": t,
        "driver": driver(t).__name__,
        "readers": {n: reader(n).__name__ for n in names},
    }

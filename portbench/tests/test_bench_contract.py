"""``BENCHMARK.json`` against the rules it is checked by: names, units,
files, cells, metrics and the cells each metric is read in."""

import json
import re

import pytest

from portbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return catalog.load()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert (catalog.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (catalog.ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fit_the_check(bench):
    """A full check of 24 cells fits its 43,200 seconds."""
    runs = 2 + 14 * 24
    need = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((catalog.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1
        assert _line(w["why"])
        assert (catalog.PACKAGE / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        catalog.reader(m["name"])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in catalog.metrics_for(bench, w["name"],
                                                      "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_for(bench, w["name"], "per_layer")
        catalog.resolve(w["name"])


def test_each_launch_group_names_a_kernel_of_the_port(bench):
    """Every prefix of a mix's launch groups matches a kernel the port
    counts, so a misspelt name cannot leave a group that nothing fills."""
    from pomcpp_tpu_torch._ext import KERNELS

    for w in bench["workloads"]:
        groups = catalog.traffic(w)["launches"]
        assert groups
        for group in groups:
            for prefix in group:
                assert any(k.startswith(prefix) for k in KERNELS), prefix

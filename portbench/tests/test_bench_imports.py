"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program (top-level names compared whole:
``pomcpp_tpu_torch`` is not ``pomcpp_tpu``)."""

import ast
import json
import subprocess
import sys

from portbench import catalog

JAX_SIDE = {"jax", "jaxlib", "flax", "pomcpp_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=catalog.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Every module of the harness, and a window of every driver on the CPU
    with the port's entry points, leave no JAX-side module loaded."""
    code = """
import torch, portbench.run, portbench.control, portbench.trace
from portbench import catalog
from portbench.drivers.common import Context, Record
bench = catalog.load()
for w in bench["workloads"]:
    r = catalog.resolve(w["name"])
    cfg, tr = dict(r["config"], boards=4), dict(r["traffic"])
    tr["steps"] = min(tr.get("steps", 1), 2)
    tr["check"] = dict(tr["check"], calls=1, boards=2)
    ctx = Context(cfg, tr, 1, 0.0, torch.device("cpu"), calls=2)
    drv = catalog.driver(tr).Driver(ctx)
    drv.setup(); rec = Record(); drv.window(rec); drv.check(rec)
"""
    loaded = _loaded(code)
    assert "pomcpp_tpu_torch" in loaded
    assert not loaded & JAX_SIDE


def test_reference_loads_nothing_of_the_program():
    code = "import portbench.reference.env, portbench.reference.chunk"
    assert not _loaded(code) & (JAX_SIDE | {"pomcpp_tpu_torch"})


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_jax_side_module():
    for path in catalog.PACKAGE.rglob("*.py"):
        assert not _imported(path) & JAX_SIDE, path
    for path in (catalog.PACKAGE / "reference").rglob("*.py"):
        assert "pomcpp_tpu_torch" not in _imported(path), path

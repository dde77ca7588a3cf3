"""Adding a configuration, a traffic mix, a cell and a per-layer metric is
adding files and entries: in a copy of the benchmark, the harness finds
them by name and no file that was there changes but ``BENCHMARK.json``'s
lists."""

import hashlib
import json
import shutil
import subprocess
import sys

from portbench import catalog


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_files_alone(tmp_path):
    shutil.copytree(catalog.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)

    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "ffa16k.json").read_text())
    cfg.update(name="ffa64k", boards=65536)
    (pkg / "configs" / "ffa64k.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "traffic" / "harmless_chunk.json").read_text())
    mix["policy"] = "random"
    (pkg / "traffic" / "random_chunk.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "chunk_ms.py").write_text(
        "def read(rec, name):\n"
        "    times = [e - s for n, s, e in rec.ops or () if n.startswith("
        "'rollout_chunk')]\n"
        "    return 1e3 * sum(times) / len(times) if times else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ffa64k", "source": cfg["source"],
                             "file": "portbench/configs/ffa64k.json",
                             "reduced": [], "why": "waves and occupancy"})
    bench["workloads"].append({"name": "ffa64k.random_chunk",
                               "config": "ffa64k", "traffic": "random_chunk",
                               "chips": 1, "why": "bombs, kicks and chains"})
    for m in bench["end_to_end"]:
        if m["name"] == "selfplay_steps_per_s":
            m["workloads"].append("ffa64k.random_chunk")
    bench["per_layer"].append({
        "name": "chunk_ms.selfplay", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "kernels", "moves":
        "selfplay_steps_per_s", "workloads": ["ffa64k.random_chunk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json\nfrom portbench import catalog\n"
            "r = catalog.resolve('ffa64k.random_chunk')\n"
            "print(json.dumps([r['config']['boards'], r['traffic']['policy'],"
            " r['driver'], r['readers']]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    boards, policy, driver, readers = json.loads(out.stdout.splitlines()[-1])
    assert (boards, policy, driver) == (65536, "random",
                                        "portbench.drivers.chunk")
    assert readers["chunk_ms.selfplay"] == "portbench.metrics.chunk_ms"
    assert readers["selfplay_steps_per_s"] == \
        "portbench.metrics.selfplay_steps_per_s"
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())

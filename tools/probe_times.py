"""Time the probe patterns of a checkout of this repo on the card.

    python tools/probe_times.py [--tree DIR] [--rows N] [--reps N]

Imports ``pomcpp_tpu_torch.probes`` from ``DIR`` (default: this checkout)
and times every pattern in both layouts at ``N`` rows and the pattern's own
K with this checkout's ``pomcpp_tpu_torch.device.time_device``, so that two
commits' kernels are read by one timer.  Prints the card's name and power
limit, the timer's floor (an empty kernel, a 16 MB copy), then one JSON
object a pattern and layout: ``{"pattern", "layout", "ms"}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _timer():
    """This checkout's ``device.py``, loaded on its own (it imports only
    torch), so that ``--tree`` decides which package is imported."""
    spec = importlib.util.spec_from_file_location(
        "_probe_timer", HERE / "pomcpp_tpu_torch" / "device.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    timer = _timer()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from pomcpp_tpu_torch import probes

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; tree {args.tree}; probes from {probes.__file__}")
    floor = timer.method_floor(dev, args.reps)
    print(f"timer floor: {json.dumps(floor)}", flush=True)
    for p in probes.PATTERNS:
        inputs = probes.pattern_inputs(p, args.rows, dev)
        for layout in probes.LAYOUTS:
            ms = timer.time_device(
                lambda: probes.run_pattern(p, inputs, layout=layout), dev,
                args.reps)
            print(json.dumps({"pattern": probes.label(p), "layout": layout,
                              "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control run of a cell: the plain reference put in the port's place
with one guarantee of the configuration broken (``driver.control``: the
movement chain cut to one round of its fixed point), run on the card at
the cell's own size over a window of ``--calls`` calls, then judged by the
cell's own check.  It must come out not correct on every seed.  The
benchmark's own runs never run it.

    python3 -m portbench.control --workload ffa.simple_chunk --seeds 1,2,3 --calls 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import catalog
from .drivers.common import MASK63, Context, Record


def control_run(workload: str, seed: int, calls: int, device) -> dict:
    """One control run -> the check's numbers and how long it took."""
    bench = catalog.load()
    cell = catalog.cell(bench, workload)
    traffic = dict(catalog.traffic(cell), warmup_calls=0)
    mod = catalog.driver(traffic)
    ctx = Context(config=catalog.config(bench, cell), traffic=traffic,
                  seed=seed & MASK63, seconds=0.0, device=device, calls=calls)
    ctx.program = mod.control(ctx)
    t0 = time.perf_counter()
    drv = mod.Driver(ctx)
    drv.setup()
    rec = Record()
    drv.window(rec)
    checks = drv.check(rec)
    return {"workload": workload, "seed": seed, "calls": rec.calls,
            "failed": rec.failed, "seconds": time.perf_counter() - t0,
            "checks": {n: v for n, v, _ in checks},
            "correct": all(v <= lim for _, v, lim in checks if lim is not None)}


def main(argv) -> int:
    import torch

    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    rows = [control_run(args.workload, int(s), args.calls,
                        torch.device("cuda", 0))
            for s in args.seeds.split(",")]
    for r in rows:
        print(json.dumps(r))
    return 0 if not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

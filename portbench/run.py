"""The benchmark's command line: one run of one cell.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up, then a window of ``--seconds`` on the card, then the check of what
the window produced against the plain reference, then one JSON line on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics from one ``torch.profiler`` session over the window
(``--trace 1``).  The numbers compared by the check are the last lines of
standard error and the last key of the JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from . import catalog, stats
from .drivers.common import MASK63, Context, Record

FORBIDDEN = ("jax", "jaxlib", "flax", "pomcpp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``pomcpp_tpu_torch`` is not ``pomcpp_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds.  The port's own nvcc output is
    ``build/torch_ext/`` there already; these are for a program that comes
    to use PyTorch's extension builder or Triton, since a later change may
    not edit the harness."""
    build = catalog.ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def launch_check(rec: Record, traffic: dict):
    """The calls short of a launch, summed over the kernels the mix names
    (0 when every call launched each).  ``traffic["launches"]`` lists one
    group of kernel-name prefixes per kernel a call must launch; a group's
    prefixes are alternatives (a kernel that merges two names both groups),
    and each group is counted on its own."""
    short = 0
    for group in traffic["launches"]:
        got = sum(n for k, n in rec.launches.items()
                  if k.startswith(tuple(group)))
        short += max(0, rec.calls - got)
    return ("kernel_launches_short", short, 0)


def breakdown(rec: Record) -> dict:
    start = rec.first_call + rec.wall_offset
    gaps = stats.idle_gaps([(s, e) for _, s, e in rec.ops], start,
                           start + rec.window_s)
    return {"device_ops": stats.top_ops(rec.ops),
            "idle_gaps": stats.label_gaps(gaps, rec.spans)}


def measure(ctx: Context, traffic: dict, trace: bool = False):
    """Set-up, the window and the check of one run on ``ctx.device`` ->
    ``(record, checks, peak device bytes or None)``; ``checks`` are
    ``(name, value, limit)``, a limit of None for a number shown and not
    compared."""
    import torch

    cuda = ctx.device.type == "cuda"
    drv = catalog.driver(traffic).Driver(ctx)
    drv.setup()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = Record()
    tracer = None
    if trace:
        from .trace import DeviceTrace

        tracer = DeviceTrace()
    with tracer or contextlib.nullcontext():
        drv.window(rec)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else None
    t0 = time.perf_counter()
    checks = drv.check(rec)
    if cuda:
        checks.append(launch_check(rec, traffic))
    rec.check_s = time.perf_counter() - t0
    if tracer is not None:
        rec.ops = tracer.ops
    return rec, checks, peak


def correct(checks) -> bool:
    return all(v <= lim for _, v, lim in checks if lim is not None)


def run(args, started: float) -> int:
    bench = catalog.load()
    cell = catalog.cell(bench, args.workload)
    cfg, traffic = catalog.config(bench, cell), catalog.traffic(cell)
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = catalog.metrics_for(bench, cell["name"], kind)
    readers = {m["name"]: catalog.reader(m["name"]) for m in wanted}
    catalog.driver(traffic)     # a missing driver fails before the card is touched

    import torch

    marks = [("imports", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    _cache_dirs()
    from .peaks import card_power_limit_w, card_rates

    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=dev)
    marks.append(("CUDA context", time.perf_counter()))
    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, traffic.get("trace_seconds", seconds))
    ctx = Context(config=cfg, traffic=traffic, seed=args.seed & MASK63,
                  seconds=seconds, device=dev)
    rec, checks, peak = measure(ctx, traffic, bool(args.trace))
    marks.append(("state and warm-up", rec.first_call))
    rec.setup_s = rec.first_call - started
    rec.rates = card_rates(0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {n: {"value": v, "limit": lim} for n, v, lim in checks
                if lim is not None}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct(checks), "attempted": rec.calls,
              "failed": rec.failed, "metrics": metrics, "device": device}
    if rec.ops is not None:
        device["busy_s"] = stats.busy([(s, e) for _, s, e in rec.ops])
        device["window_s"] = rec.window_s
        result["breakdown"] = breakdown(rec)
    result["card"] = {"power_limit_w": card_power_limit_w(0),
                      "sms": rec.rates.sms, "max_sm_mhz": rec.rates.clock_mhz}
    result["checks"] = compared
    last = started
    for what, at in marks:
        print(f"portbench: set-up {what} {at - last:.3f} s", file=sys.stderr)
        last = at
    print(f"portbench: check took {rec.check_s:.3f} s", file=sys.stderr)
    if rec.latencies_s:
        lat = rec.latencies_s
        print(f"portbench: {len(lat)} steps, latency median "
              f"{stats.median(lat) * 1e3:.4f} ms, max {max(lat) * 1e3:.3f} ms, "
              f"{sum(x > 0.003 for x in lat)} over 3 ms; the window's "
              f"{rec.window_s - sum(lat):.3f} s outside the steps",
              file=sys.stderr)
    for n, v, lim in checks:
        if lim is None:
            print(f"portbench: {n} {v}", file=sys.stderr)
    print(json.dumps(result))
    for n, c in compared.items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


def main(argv, started: float = None) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    try:
        return run(args, started)
    except ModuleNotFoundError as e:
        print(f"portbench: {e} (run from the root of a checkout of the "
              "repository)", file=sys.stderr)
        return 4

"""The control run of the ``ppo.vs_simple`` cell, and the readings its
limits are set from: the cell's own driver, set-up and check at the cell's
own size on the card, over a window of ``--calls`` iterations, with one of
``PROGRAMS`` in the port's place:

* ``port``: the program itself (the sound readings);
* ``fp8``: the program with its torso run through float8_e4m3fn
  (``drivers.train.control``: the precision below the configuration's
  bf16), which must come out not correct;
* ``skipped_update`` and ``half_batch``: planted faults, which must come
  out not correct: the parameters put back after the iteration, and the
  update blind to every other row of the batch.

The benchmark's own runs never run it.  ``--leaves`` prints each leaf's
readings of each sampled iteration (``drivers.train.leaf_row``).

    python3 -m portbench.control_train --seeds 1,2,3 --calls 3 \\
        --programs port,fp8,skipped_update,half_batch
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import catalog
from .drivers import train
from .drivers.common import MASK63, Context, Record

WORKLOAD = "ppo.vs_simple"


def skipped_update(ctx: Context):
    """The program with the parameters put back after each iteration."""
    base = train.port_program(ctx)

    def call(ts, es, opp, record):
        before = [p.detach().clone() for p in ts.model.parameters()]
        out = base(ts, es, opp, record)
        with torch.no_grad():
            for p, q in zip(out[0].model.parameters(), before):
                p.copy_(q)
        return out
    return call


def half_batch(ctx: Context):
    """The iteration composed by hand, as ``ppo_train_step`` composes it,
    with the update blind to every other row of the batch."""
    from pomcpp_tpu_torch.learner import ppo

    cfg = train.ppo_config(ctx)
    device = None if ctx.device.type == "cuda" else ctx.device

    def call(ts, es, opp, record):
        record = {} if record is None else record
        es2, traj, boot, opp2 = ppo.collect_rollout_batch(
            ts.model, es, cfg, ts.gen, opp, host_gen=ts.host_gen,
            device=device, record=record)
        adv, ret = ppo.compute_gae(traj, boot, cfg)
        record.update(traj=traj, adv=adv, ret=ret, boot_value=boot)
        flat = ppo.flatten_batch(traj, adv, ret)
        mask = flat[5]
        keep = torch.arange(mask.shape[0], device=mask.device) % 2 == 0
        ts, metrics = ppo.ppo_update(ts, flat[:5] + (mask & keep,), cfg,
                                     record=record)
        return ts, es2, metrics, opp2
    return call


PROGRAMS = {"port": train.port_program, "fp8": train.control,
            "skipped_update": skipped_update, "half_batch": half_batch}


def control_run(seed: int, calls, device, program: str = "fp8",
                seconds: float = 0.0, leaves: bool = False) -> dict:
    """One run of the cell's window and check with ``PROGRAMS[program]``
    -> the check's numbers."""
    bench = catalog.load()
    cell = catalog.cell(bench, WORKLOAD)
    traffic = catalog.traffic(cell)
    ctx = Context(config=catalog.config(bench, cell), traffic=traffic,
                  seed=seed & MASK63, seconds=seconds, device=device,
                  calls=calls)
    ctx.program = PROGRAMS[program](ctx)
    t0 = time.perf_counter()
    drv = train.Driver(ctx)
    drv.setup()
    rec = Record()
    drv.window(rec)
    checks = drv.check(rec)
    row = {"workload": WORKLOAD, "program": program, "seed": seed,
           "iterations": rec.calls // drv.steps, "window_s": rec.window_s,
           "failed": rec.failed, "seconds": time.perf_counter() - t0,
           "checks": {n: v for n, v, _ in checks},
           "correct": all(v <= lim for _, v, lim in checks
                          if lim is not None)}
    if leaves:
        row["leaves"] = drv.leaf_rows
    return row


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_train")
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--programs", default="fp8")
    p.add_argument("--leaves", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_train: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for program in args.programs.split(","):
        for s in seeds:
            rows.append(control_run(s, args.calls, dev, program,
                                    args.seconds, args.leaves))
            print(json.dumps(rows[-1]), flush=True)
    bad = [r for r in rows if r["correct"] != (r["program"] == "port")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

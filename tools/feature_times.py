"""Time the actor-critic's feature kernel against its plain version on the card.

    python tools/feature_times.py [--boards N] [--reps N]

At ``N`` boards (default 2048, the PPO cell's) of games after SimpleAgent
steps, for learner slot 0 and for all four slots: the device time of
``ego_features_kernel`` and of the plain version
(``pomcpp_tpu_torch.device.time_device``: cold L2, the mean of ``reps``
calls), the kernel's byte bound (what it must read and write over 3.35 TB/s),
the host time one call takes to return (median of 200 calls, the stream
synchronised every 20), the PyTorch operators each dispatches, and that the
two agree bit for bit; then the host time of one act (``_policy_slots``:
features, forward, draw, ``logp``) with the features of each.  Prints the
card's name and power limit, the compiler's line for the kernel, the
timer's floor (an empty kernel, a 16 MB copy), then one JSON object a slot
set.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pomcpp_tpu_torch import _ext, launch  # noqa: E402
from pomcpp_tpu_torch.device import method_floor, time_device  # noqa: E402
from pomcpp_tpu_torch.learner import ppo  # noqa: E402
from pomcpp_tpu_torch.models import features  # noqa: E402

HBM = 3.35e12


def host_ms(fn, calls: int = 200, sync_every: int = 20) -> float:
    """Median host milliseconds for ``fn()`` to return."""
    fn()
    torch.cuda.synchronize()
    times = []
    for k in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        if k % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boards", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _ext.features_lib()
    for line in _ext.build_log(("features",)).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    print(f"timer floor: {json.dumps(method_floor(dev, args.reps))}",
          flush=True)
    b = args.boards
    game = chip_smoke.feature_states(dev, b, 5)["simple"]
    cfg = ppo.PPOConfig(opponent="simple", learner_slots=(0,), fused_env=True)
    ts = ppo.ppo_init(5, cfg, device=dev)
    for slots in ((0,), (0, 1, 2, 3)):
        n = len(slots)
        out = torch.empty((b, n, 1863), dtype=torch.bfloat16, device=dev)
        want = features.ego_features_plain(game, slots, 4)
        got = features.ego_features(game, slots, 4, out=out)
        off = (got.view(torch.int16) != want.view(torch.int16)).flatten()
        row = {"boards": b, "slots": list(slots),
               "bit_equal": not bool(off.any())}
        if off.any():       # where they differ: flat index, cell, channel
            at = off.nonzero()[:8, 0].tolist()
            row["differ"] = [int(off.sum()), [
                (i, i // 23, i % 23, float(got.flatten()[i]),
                 float(want.flatten()[i])) for i in at]]
        read = b * (5 * 121 * 4 + 5 * 4 * 4 + 4)
        wrote = b * n * 1863 * 2
        row["bound_us"] = 1e6 * (read + wrote) / HBM
        row["kernel_device_us"] = 1e3 * time_device(
            lambda: features.ego_features(game, slots, 4, out=out), dev,
            args.reps)
        row["plain_device_us"] = 1e3 * time_device(
            lambda: features.ego_features_plain(game, slots, 4), dev,
            args.reps)
        row["kernel_roofline_pct"] = 100 * row["bound_us"] / \
            row["kernel_device_us"]
        row["kernel_host_ms"] = host_ms(
            lambda: features.ego_features(game, slots, 4, out=out))
        row["plain_host_ms"] = host_ms(
            lambda: features.ego_features_plain(game, slots, 4))
        row["kernel_ops"] = len(chip_smoke.device_ops(
            lambda: features.ego_features(game, slots, 4, out=out)))
        row["plain_ops"] = len(chip_smoke.device_ops(
            lambda: features.ego_features_plain(game, slots, 4)))
        card = launch.card
        for name, switch in (("act_kernel_host_ms", card),
                             ("act_plain_host_ms", lambda *_: None)):
            launch.card = switch    # None: the plain version
            with torch.no_grad():
                row[name] = host_ms(lambda: ppo._policy_slots(
                    ts.model, game, ts.gen, slots, 4, out=out))
        launch.card = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

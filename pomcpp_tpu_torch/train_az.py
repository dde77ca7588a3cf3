"""Search-distillation training of the port: tree search plans, the
actor-critic imitates (``learner/distill.py``).

    python -m pomcpp_tpu_torch.train_az --batch 1024 --iters 20 \\
        [--rollout 8] [--sims 16] [--depth 12] [--tree-depth 6] [--guided] \\
        [--resume artifacts/ppo_randseat] [--ckpt-dir DIR]

The flags of the JAX package's ``scripts/train_az.py``; ``--device``
(default: the card) takes the place of ``--cpu``.  The env steps through
the fused env step on every device (on the card ``fused_step_kernel<true>``,
which takes any batch size).  ``--resume`` warm-starts from a checkpoint
directory in the JAX package's npz format (``utils.checkpoint``: weights,
Adam state, key and update count); ``--ckpt-dir`` writes one after every
iteration.  Each iteration prints the JAX script's JSON line: the metrics,
``env_steps_per_s`` (boards x rollout steps over the iteration's wall time,
the host fetch of the metrics inside it) and ``search_steps_per_s`` by the
same formula as the JAX script (env steps x 4 agents x sims x (tree depth +
playout depth) over the same time).
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rollout", type=int, default=8)
    p.add_argument("--sims", type=int, default=16)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--tree-depth", type=int, default=6)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default="")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card")
    p.add_argument("--guided", action="store_true",
                   help="net-guided PUCT targets (mcts_moves_net) instead "
                        "of random playouts -- full AlphaZero loop")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint dir to warm-start params from")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from .device import resolve_device
    from .env.environment import env_reset
    from .learner.distill import DistillConfig, az_train_step, distill_init
    from .utils.checkpoint import restore_checkpoint, save_checkpoint

    device = resolve_device(args.device)
    cfg = DistillConfig(rollout_len=args.rollout, n_sim=args.sims,
                        depth=args.depth, max_tree_depth=args.tree_depth,
                        lr=args.lr, fused_env=True, guided=args.guided)
    ts = distill_init(args.seed, cfg, device)
    if args.resume:
        ts = restore_checkpoint(args.resume, ts)
        print(f"warm-started params from {args.resume}")
    es = env_reset(args.seed + 1, args.batch, device=device)

    steps_per_iter = args.batch * cfg.rollout_len
    for it in range(args.iters):
        t0 = time.perf_counter()
        ts, es, metrics = az_train_step(ts, es, cfg, device=device)
        # The host fetch is the barrier; keep it inside the timed window.
        m = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        m.update(
            iter=it, update=ts.update_count,
            env_steps_per_s=round(steps_per_iter / dt, 1),
            search_steps_per_s=round(
                steps_per_iter * 4 * cfg.n_sim
                * (cfg.max_tree_depth + cfg.depth) / dt, 1),
            sec=round(dt, 2))
        print(json.dumps(m), flush=True)
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, ts)


if __name__ == "__main__":
    main()

"""PPO training script of the port, on one device.

    python -m pomcpp_tpu_torch.train_ppo --batch 2048 --iters 2000 \\
        --rollout 64 --epochs 1 --opponent simple --learner-slots 0 --fused \\
        --ckpt-dir build/ppo_vs_simple_torch --ckpt-every 100

The flags of the JAX package's ``scripts/train_ppo.py``, with the same
minibatch auto-scaling; ``--device`` (default: the card) takes the place of
``--cpu``, and there is no mesh.  Each iteration prints the JAX script's
metrics line (one JSON object; the host fetch of the metrics is inside the
timed window).  ``--ckpt-dir`` writes weights-only checkpoints in the JAX
package's npz format (``utils.checkpoint``), which ``--resume`` restores;
the environment and opponent state are not saved.
"""

from __future__ import annotations

import argparse
import json
import time


def auto_minibatches(batch: int, rollout: int, n_slots: int) -> int:
    """Minibatches per epoch so that one minibatch holds at most 128k rows."""
    n = batch * rollout * n_slots
    mbs = 2
    while n // mbs > 128 * 1024:
        mbs *= 2
    return mbs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--rollout", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=0,
                   help="PPO minibatches per epoch; 0 = auto-scale so one "
                        "minibatch stays <= 128k samples")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default="")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--team", action="store_true", help="2v2 team mode")
    p.add_argument("--fused", action="store_true",
                   help="step rollouts through the env kernels")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card")
    p.add_argument("--draw-penalty", type=float, default=0.0,
                   help="reward subtracted from survivors of a step-cap draw")
    p.add_argument("--opponent", type=str, default="",
                   help="policy for the slots NOT in --learner-slots "
                        "(random/harmless/lazy/simple, or frozen / "
                        "frozen+simple with --frozen-ckpt); '' = self-play")
    p.add_argument("--learner-slots", type=str, default="0",
                   help="comma-separated net-controlled agent ids "
                        "(only with --opponent)")
    p.add_argument("--frozen-ckpt", type=str, default="",
                   help="checkpoint whose params drive the frozen-net slots")
    p.add_argument("--frozen-slots", type=str, default="",
                   help="comma-separated frozen-net agent ids for "
                        "opponent=frozen+simple; empty = all non-learner "
                        "slots")
    p.add_argument("--view-range", type=int, default=4,
                   help="observation radius (4 = the 9x9 fogged view)")
    p.add_argument("--randomize-positions", action="store_true",
                   help="permute corner seats on every reset")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from .device import resolve_device
    from .env.environment import env_reset
    from .learner.ppo import PPOConfig, opponent_state_init, ppo_init, \
        ppo_train_step
    from .utils.checkpoint import restore_checkpoint, save_checkpoint

    device = resolve_device(args.device)
    slots = tuple(int(s) for s in args.learner_slots.split(",")) \
        if args.opponent else (0, 1, 2, 3)
    mbs = args.minibatches or auto_minibatches(args.batch, args.rollout,
                                               len(slots))
    cfg = PPOConfig(
        rollout_len=args.rollout, lr=args.lr, team_mode=args.team,
        fused_env=args.fused, epochs=args.epochs, minibatches=mbs,
        draw_penalty=args.draw_penalty, opponent=args.opponent,
        learner_slots=slots,
        frozen_slots=tuple(int(s) for s in args.frozen_slots.split(",")
                           if s != ""),
        view_range=args.view_range,
        randomize_positions=args.randomize_positions)
    ts = ppo_init(args.seed, cfg, device)
    frozen_model = None
    if args.opponent in ("frozen", "frozen+simple"):
        if not args.frozen_ckpt:
            raise SystemExit("--opponent frozen needs --frozen-ckpt")
        frozen_model = restore_checkpoint(
            args.frozen_ckpt, ppo_init(args.seed, cfg, device)).model
        frozen_model.requires_grad_(False)
    es = env_reset(args.seed + 1, args.batch,
                   randomize_positions=args.randomize_positions,
                   device=device)
    opp = opponent_state_init(args.batch, cfg, device) if args.opponent \
        else None
    if args.resume and args.ckpt_dir:
        ts = restore_checkpoint(args.ckpt_dir, ts)
        print(f"resumed weights from {args.ckpt_dir} at update "
              f"{ts.update_count} (no env bundle)")

    steps_per_iter = args.batch * cfg.rollout_len
    for it in range(args.iters):
        t0 = time.perf_counter()
        if args.opponent:
            ts, es, metrics, opp = ppo_train_step(
                ts, es, cfg, opp, frozen_model=frozen_model, device=device)
        else:
            ts, es, metrics = ppo_train_step(ts, es, cfg, device=device)
        # The host fetch is the barrier; keep it inside the timed window.
        m = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        m.update(iter=it, update=ts.update_count,
                 env_steps_per_s=round(steps_per_iter / dt, 1),
                 sec=round(dt, 2))
        print(json.dumps(m), flush=True)
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, ts)
            print(f"checkpointed -> {args.ckpt_dir}")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, ts)


if __name__ == "__main__":
    main()

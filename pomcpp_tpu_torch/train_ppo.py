"""PPO training script of the port, on one device or data parallel.

    python -m pomcpp_tpu_torch.train_ppo --batch 2048 --iters 2000 \\
        --rollout 64 --epochs 1 --opponent simple --learner-slots 0 --fused \\
        --ckpt-dir build/ppo_vs_simple_torch --ckpt-every 100

The flags of the JAX package's ``scripts/train_ppo.py``, with the same
minibatch auto-scaling; ``--device`` (default: the card) takes the place of
``--cpu``.  Each iteration prints the JAX script's metrics line (one JSON
object; the host fetch of the metrics is inside the timed window).

Checkpoints.  ``--ckpt-dir`` gets, every ``--ckpt-every`` iterations and at
the end, the weights-only checkpoint in the JAX package's npz format and
then the full resume bundle under ``<ckpt_dir>/resume``
(``utils.checkpoint``).  ``--resume`` restores the bundle when it is there
(net, optimizer, generator states, env and opponent state, iteration) and
goes on from its iteration, so a killed and resumed run prints what the
straight run prints; without a bundle it restores the weights only.

Data parallel.  Launched by ``python -m torch.distributed.run
--nproc-per-node W -m pomcpp_tpu_torch.train_ppo ...``, the script reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, joins the process group
(``parallel.boards_mesh``: NCCL on cards, gloo with ``--device cpu``),
puts rank r on card ``LOCAL_RANK`` unless ``--device`` names one, and,
when ``--batch`` divides by W, gives each rank its rows of the global
batch; otherwise every rank runs the whole batch.  Rank 0 alone prints the
metrics and writes checkpoints; the bundle holds the gathered global env
and opponent state and every rank's generator states, and resumes only at
the same world size.
"""

from __future__ import annotations

import argparse
import json
import os
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


def _load(args, cfg, device, rank: int, world: int):
    """Fresh or resumed ``(ts, es, opp, start_it)`` with the GLOBAL env and
    opponent state."""
    from .env.environment import env_reset
    from .learner.ppo import opponent_state_init, ppo_init
    from .utils.checkpoint import restore_bundle, restore_checkpoint

    ts = ppo_init(args.seed, cfg, device, rank=rank)
    es = env_reset(args.seed + 1, args.batch,
                   randomize_positions=args.randomize_positions,
                   device=device)
    opp = opponent_state_init(args.batch, cfg, device) if args.opponent \
        else None
    start_it = 0
    resume_dir = os.path.join(args.ckpt_dir, "resume")
    if args.resume and args.ckpt_dir and os.path.exists(args.ckpt_dir):
        if os.path.exists(resume_dir):
            try:
                ts, es, opp, start_it = restore_bundle(resume_dir, ts, device,
                                                       rank, world)
            except ValueError as e:
                raise SystemExit(str(e)) from None
            if rank == 0:
                print(f"resumed full bundle from {resume_dir} at iter "
                      f"{start_it}", flush=True)
        else:
            ts = restore_checkpoint(args.ckpt_dir, ts)
            if rank == 0:
                print(f"resumed weights from {args.ckpt_dir} at update "
                      f"{ts.update_count} (no env bundle)", flush=True)
    return ts, es, opp, start_it


def main(argv=None) -> None:
    args = parse_args(argv)
    from .device import resolve_device
    from .learner.ppo import PPOConfig, ppo_init, ppo_train_step
    from .parallel.mesh import (
        boards_mesh,
        gather_batch,
        shard_batch,
        shard_env_batch,
    )
    from .utils.checkpoint import (
        restore_checkpoint,
        save_bundle,
        save_checkpoint,
    )

    mesh = None
    if "WORLD_SIZE" in os.environ:
        mesh = boards_mesh(device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    rank = mesh.rank if mesh else 0
    world = mesh.world_size if mesh else 1
    sharded = mesh is not None and args.batch % world == 0
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
    frozen_model = None
    if args.opponent in ("frozen", "frozen+simple"):
        if not args.frozen_ckpt:
            raise SystemExit("--opponent frozen needs --frozen-ckpt")
        frozen_model = restore_checkpoint(
            args.frozen_ckpt, ppo_init(args.seed, cfg, device)).model
        frozen_model.requires_grad_(False)
    # A run that does not shard runs the same replica on every rank.
    ts, es, opp, start_it = _load(args, cfg, device, rank if sharded else 0,
                                  world)
    if sharded:
        es = shard_env_batch(es, mesh)
        opp = None if opp is None else shard_batch(opp, mesh)
        if rank == 0:
            print(f"boards mesh over {world} rank(s)", flush=True)
    learner_mesh = mesh if sharded else None

    def save_all(it):
        gen = (ts.gen.get_state(), ts.host_gen.get_state())
        g_es, g_opp, gens = es, opp, [gen]
        if learner_mesh is not None:
            g_es = gather_batch(es, mesh)
            g_opp = None if opp is None else gather_batch(opp, mesh)
            states = gather_batch(tuple(s[None] for s in gen), mesh)
            gens = list(zip(*(s.unbind() for s in states)))
        elif mesh is not None:
            gens = [gen] * world
        if rank == 0:
            save_checkpoint(args.ckpt_dir, ts)
            save_bundle(os.path.join(args.ckpt_dir, "resume"), ts, g_es,
                        g_opp, it + 1, gens)

    steps_per_iter = args.batch * cfg.rollout_len
    for it in range(start_it, args.iters):
        t0 = time.perf_counter()
        if args.opponent:
            ts, es, metrics, opp = ppo_train_step(
                ts, es, cfg, opp, frozen_model=frozen_model, device=device,
                mesh=learner_mesh)
        else:
            ts, es, metrics = ppo_train_step(ts, es, cfg, device=device,
                                             mesh=learner_mesh)
        # The host fetch is the barrier; keep it inside the timed window.
        m = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        m.update(iter=it, update=ts.update_count,
                 env_steps_per_s=round(steps_per_iter / dt, 1),
                 sec=round(dt, 2))
        if rank == 0:
            print(json.dumps(m), flush=True)
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            save_all(it)
            if rank == 0:
                print(f"checkpointed -> {args.ckpt_dir}", flush=True)
    if args.ckpt_dir:
        save_all(args.iters - 1)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

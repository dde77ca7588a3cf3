"""Policy evaluation of the port: win rates over batched games.

    python -m pomcpp_tpu_torch.evaluate --games 64 --steps 400 \\
        --agents simple,simple,random,random [--ckpt artifacts/ppo_randseat]

A thin command line over ``arena.play_games`` with the flags of the JAX
package's ``scripts/evaluate.py``; ``--device`` (default: the card) takes
the place of ``--cpu``.  Agent names: random/harmless/lazy/simple/ppo/mcts/
azmcts/lookahead (``ppo`` and ``azmcts`` load ``--ckpt``, a checkpoint
directory in the JAX package's npz format; ``--ckpt gen1=PATH,gen2=PATH``
names several for ``ppo:gen1``-style slots; the planners take
``--mcts-sims`` / ``--mcts-depth``).  ``--rotate`` plays games/4 per seat
rotation and reports per policy (with ``--team``: the four team seatings).
"""

from __future__ import annotations

import argparse
import collections


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--agents", type=str, default="simple,simple,simple,simple")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card")
    p.add_argument("--team", action="store_true",
                   help="2v2 team mode ({0,2} vs {1,3}); reports team win "
                        "rates")
    p.add_argument("--mcts-sims", type=int, default=24)
    p.add_argument("--mcts-depth", type=int, default=12)
    p.add_argument("--view-range", type=int, default=4,
                   help="observation radius for ppo slots (matches the "
                        "checkpoint's training view; 10 = full board)")
    p.add_argument("--rotate", action="store_true",
                   help="play games/4 per seat rotation of the line-up and "
                        "aggregate per POLICY; with --team, the 4 team "
                        "seatings (diagonal swap x within-team swap)")
    return p.parse_args(argv)


def load_nets(names, ckpt: str, view_range: int, device):
    """The models of the net slots (``ppo``/``azmcts`` kinds) of ``names``:
    one model for a single ``--ckpt PATH``, a dict keyed by slot name for
    ``--ckpt key=PATH,...``; None without net slots."""
    from .learner.ppo import PPOConfig, ppo_init
    from .utils.checkpoint import restore_checkpoint

    net_names = [n for n in names if n.split(":", 1)[0] in ("ppo", "azmcts")]
    if not net_names:
        return None

    def load(path):
        ts = ppo_init(0, PPOConfig(view_range=view_range), device)
        return restore_checkpoint(path, ts).model

    if "=" not in ckpt:
        return load(ckpt)
    paths = dict(kv.split("=", 1) for kv in ckpt.split(","))
    return {n: load(paths[n.split(":", 1)[1] if ":" in n else n])
            for n in set(net_names)}


def search_kwargs_for(kinds, sims: int, depth: int):
    if "azmcts" in kinds:
        return {"n_sim": sims}
    if "mcts" in kinds:
        return {"n_sim": sims, "depth": depth}
    if "lookahead" in kinds:
        return {"depth": depth}
    return None


def rotations_of(names, rotate: bool, team: bool):
    if rotate and team:
        a, b, c, d = names
        # Both which diagonal a team sits on and which corner of it each
        # member takes.
        return [(a, b, c, d), (b, a, d, c), (c, d, a, b), (d, c, b, a)]
    if rotate:
        return [tuple(names[-r:] + names[:-r]) for r in range(4)]
    return [tuple(names)]


def main(argv=None) -> None:
    args = parse_args(argv)
    from .arena import play_games
    from .device import resolve_device

    device = resolve_device(args.device)
    names = args.agents.split(",")
    if len(names) != 4:
        raise SystemExit("--agents needs 4 comma-separated names")
    kinds = [n.split(":")[0] for n in names]
    nets = load_nets(names, args.ckpt, args.view_range, device)
    search_kwargs = search_kwargs_for(kinds, args.mcts_sims, args.mcts_depth)
    rotations = rotations_of(names, args.rotate, args.team)
    games_per = args.games // len(rotations)

    counts = collections.Counter()
    seat_wins = collections.Counter()  # (policy, seat) -> wins, FFA rotate
    max_steps = total = 0
    for ri, lineup in enumerate(rotations):
        res = play_games(list(lineup), games=games_per, steps=args.steps,
                         nets=nets, seed=args.seed + ri, team=args.team,
                         search_kwargs=search_kwargs,
                         view_range=args.view_range, device=device)
        max_steps = max(max_steps, res.steps)
        total += games_per
        for g in range(games_per):
            win = int(res.winners[g])
            if not res.done[g]:
                counts["timeout"] += 1
            elif res.draws[g]:
                counts["draw"] += 1
            elif args.team:
                members = [i for i in range(4) if i % 2 == win]
                if args.rotate:
                    label = "+".join(sorted(lineup[i] for i in members))
                    counts[f"win({label})"] += 1
                else:
                    label = "+".join(lineup[i] for i in members)
                    counts[f"team{win}({label})"] += 1
            elif args.rotate:
                counts[f"win({lineup[win]})"] += 1
                seat_wins[(lineup[win], win)] += 1
            else:
                counts[f"agent{win}({lineup[win]})"] += 1
    print(f"games={total} steps_played<={max_steps}")
    for k, v in sorted(counts.items()):
        print(f"  {k}: {v} ({100 * v / total:.1f}%)")
    if args.rotate and not args.team:
        # Seat-conditional win rates of each policy seated once a rotation.
        for name in sorted(set(names)):
            if names.count(name) != 1:
                continue
            rates = [100 * seat_wins[(name, s)] / games_per for s in range(4)]
            mean = sum(rates) / 4
            sd = (sum((r - mean) ** 2 for r in rates) / 4) ** 0.5
            print(f"  seats({name}): " + " ".join(f"{r:.1f}%" for r in rates)
                  + f"  (sd {sd:.1f})")


if __name__ == "__main__":
    main()

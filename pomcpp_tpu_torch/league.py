"""Elo league of the port over a roster of policies: sampled 4-slot
line-ups, batched games, ratings table.

    python -m pomcpp_tpu_torch.league --roster simple,random,harmless,lazy \\
        --rounds 6 --games 32 --steps 300 [--ckpt artifacts/ppo_randseat]

The flags of the JAX package's ``scripts/league.py``; ``--device``
(default: the card) takes the place of ``--cpu``.  Include ``ppo`` (the raw
net) or ``azmcts`` (net-guided PUCT) in the roster to rate a checkpoint;
name several with ``--ckpt gen1=PATH,gen2=PATH`` and roster entries
``ppo:gen1,ppo:gen2,azmcts:gen2``.  ``--all4`` seats four distinct roster
members a game instead of 2+2 pair line-ups.
"""

from __future__ import annotations

import argparse
import itertools
import random


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--roster", type=str, default="simple,random,harmless,lazy")
    p.add_argument("--rounds", type=int, default=6,
                   help="line-ups to play (cycled from all 2v2-ish pairings)")
    p.add_argument("--games", type=int, default=32)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card")
    p.add_argument("--all4", action="store_true",
                   help="four distinct roster members per game instead of "
                        "2+2 pair line-ups (avoids two-net stalemates)")
    p.add_argument("--view-range", type=int, default=4,
                   help="observation radius for net slots (matches the "
                        "checkpoints' training view; 10 = full board)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from .arena import League, play_games
    from .device import resolve_device
    from .evaluate import load_nets

    device = resolve_device(args.device)
    roster = args.roster.split(",")
    nets = load_nets(roster, args.ckpt, args.view_range, device)
    league = League(roster)
    pairs = list(itertools.combinations(roster, 2)) or [(roster[0],) * 2]
    rng = random.Random(args.seed)
    for rd in range(args.rounds):
        if args.all4 and len(roster) >= 4:
            lineup = rng.sample(roster, 4)
        else:
            a, b = pairs[rd % len(pairs)]
            lineup = [a, b, a, b] if rd % 2 == 0 else [b, a, b, a]
        res = play_games(lineup, args.games, args.steps, nets=nets,
                         seed=args.seed + 1000 * rd + rng.randint(0, 999),
                         view_range=args.view_range, device=device)
        league.record(lineup, res)
        print(f"round {rd}: {lineup} -> {int(res.done.sum())}/{args.games} "
              f"finished in <={res.steps} steps", flush=True)

    print("\nElo table:")
    for name, rating, games in league.table():
        print(f"  {name:10s} {rating:7.1f}  ({games} games)")


if __name__ == "__main__":
    main()

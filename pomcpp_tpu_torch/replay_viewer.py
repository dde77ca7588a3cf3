"""Replay-driven debugging: record a game to npz, then page through it.

    record: python -m pomcpp_tpu_torch.replay_viewer --record build/game.npz
                [--seed N] [--steps N] [--policy simple|random|harmless]
                [--device cpu]
    view:   python -m pomcpp_tpu_torch.replay_viewer --view build/game.npz
                (keys: Enter/n next, p prev, g <t> goto, q quit)
    dump:   python -m pomcpp_tpu_torch.replay_viewer --view build/game.npz
                --frames 10:14        # non-interactive

Counterpart of ``scripts/replay_viewer.py``.  ``--record`` plays the exact
engine from the reference's board for ``--seed`` as it stands (no forced
kick, unlike the demo), with the demo's policies (``play_demo``), advances
``timestep`` after every step, and saves every state and joint move in the
npz layout both packages share (``utils.replay``): a replay recorded by
either package is viewed identically by both.  ``--view`` is host code and
needs no card; frames are coloured when standard output is a terminal.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .core.board_gen import init_state_np
from .core.state import I32, empty_state
from .device import resolve_device
from .play_demo import POLICIES, advance, policy_moves
from .render import render_state
from .utils.replay import load_replay, record_game, replay_frame, save_replay

_MOVE_NAMES = ("idle", "up", "down", "left", "right", "bomb")


def record(path: str, seed: int = 0x1337, steps: int = 120,
           policy: str = "simple", device=None, moves=None):
    """Record a game of ``steps`` steps on ``device`` (None: the card) to
    ``path``; ``moves`` ([steps, 4]) replaces the policy (dead agents'
    moves still zeroed).  Returns ``(states, moves)`` as saved."""
    device = resolve_device(device)
    s = init_state_np(seed, device=device)
    act = None if moves is not None else policy_moves(policy, seed, device)

    def moves_fn(t, game):
        if moves is None:
            return act(game)
        mv = torch.as_tensor(moves[t]).to(device=device, dtype=I32)
        return torch.where(game.agent_dead, 0, mv.reshape(1, 4))

    states, mv = record_game(s, advance, moves_fn, steps)
    save_replay(path, states, mv)
    return states, mv


def frame_text(states, moves, t: int, n_steps: int) -> str:
    """Frame ``t`` of a replay and the joint move that follows it."""
    lines = [f"--- step {t}/{n_steps} ---",
             render_state(replay_frame(states, t), color=sys.stdout.isatty())]
    if t < n_steps:
        lines.append(f"next joint move: "
                     f"{[_MOVE_NAMES[int(m)] for m in moves[t]]}")
    else:
        lines.append("(final state)")
    return "\n".join(lines)


def view(path: str, frames: str = "") -> None:
    """Print frames ``A:B`` of a replay, or page through it."""
    states, moves = load_replay(path, empty_state(None, "cpu"))
    n_steps = moves.shape[0]
    if frames:
        a, _, b = frames.partition(":")
        lo = int(a or 0)
        hi = int(b) if b else lo + 1
        for t in range(lo, min(hi, n_steps + 1)):
            print(frame_text(states, moves, t, n_steps))
        return

    t = 0
    while True:
        print("\033[2J\033[H", end="")
        print(frame_text(states, moves, t, n_steps))
        try:
            cmd = input("[n]ext p)rev g <t> q)uit > ").strip()
        except EOFError:
            return
        if cmd in ("q", "quit"):
            return
        if cmd in ("p", "prev"):
            t = max(0, t - 1)
        elif cmd.startswith("g"):
            try:
                t = max(0, min(n_steps, int(cmd.split()[-1])))
            except (ValueError, IndexError):
                pass
        else:
            t = min(n_steps, t + 1)


def main(argv=None, moves=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--record", type=str, help="record a game to this npz")
    p.add_argument("--view", type=str, help="view a recorded npz")
    p.add_argument("--seed", type=int, default=0x1337)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--policy", choices=POLICIES, default="simple")
    p.add_argument("--frames", type=str, default="",
                   help="A:B non-interactive frame dump")
    p.add_argument("--device", default=None,
                   help="cpu to record on the CPU (default: the card)")
    args = p.parse_args(argv)
    if args.record:
        record(args.record, args.seed, args.steps, args.policy, args.device,
               moves)
        print(f"recorded {args.steps} steps (seed {args.seed}, "
              f"{args.policy} policies) -> {args.record}")
    elif args.view:
        view(args.view, args.frames)
    else:
        p.error("need --record or --view")
    return 0


if __name__ == "__main__":
    sys.exit(main())

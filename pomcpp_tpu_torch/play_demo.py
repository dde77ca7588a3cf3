"""Rendered demo game: four agents on the reference's board, on the exact
engine.

    python -m pomcpp_tpu_torch.play_demo [--seed N] [--steps N] [--fps N]
        [--policy simple|random|harmless] [--no-render] [--pause]
        [--device cpu]

Counterpart of ``scripts/play_demo.py`` (the reference demo, src/main.cpp:
8-25): the reference's board for ``--seed`` (``init_state_np``), kick on
for every agent as the reference demo forces it, the exact ``step`` with
the exact SimpleAgent (``agents.simple``) or a scripted policy
(``agents.basic``), drawn in the terminal after every step.  Dead agents'
moves are zeroed, the game loop advances ``timestep`` after every step (the
exact step does not) and the game ends when at most one agent lives.

The policies draw from a CPU ``torch.Generator`` seeded with ``--seed``, so
a game on the card and on the CPU is one game.  ``play_game(...,
moves=)`` plays injected moves instead (``[steps, 4]``; the tests hold
the JAX script's games with it).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .agents.basic import harmless_agent, random_agent
from .agents.simple import simple_agent_init_batch, simple_agent_joint
from .core.board_gen import init_state_np
from .core.constants import AGENT_COUNT
from .core.state import I32, state_of
from .device import resolve_device
from .engine.step import step
from .render import print_state

POLICIES = ("simple", "random", "harmless")


def policy_moves(policy: str, seed: int, device):
    """``act(state) -> i32[1, 4]`` for one board: the policy's moves with
    dead agents' zeroed, drawn from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.arange(AGENT_COUNT)
    if policy == "simple":
        box = {"ast": simple_agent_init_batch(1, device)}

        def act(s):
            rands = torch.randint(0, 5, (1, AGENT_COUNT), generator=gen,
                                  dtype=I32).to(device)
            mv, _, box["ast"] = simple_agent_joint(s, box["ast"], rands)
            return torch.where(s.agent_dead, 0, mv).to(I32)
    elif policy in ("random", "harmless"):
        draw = random_agent if policy == "random" else harmless_agent

        def act(s):
            mv = draw(gen, s, ids).to(device)
            return torch.where(s.agent_dead, 0, mv).to(I32)
    else:
        raise ValueError(f"policy {policy!r}: one of {POLICIES}")
    return act


def advance(s, mv):
    """One exact step and the game loop's ``timestep + 1``."""
    s = step(s, mv)
    return s._replace(timestep=s.timestep + 1)


def play_game(seed: int, steps: int, policy: str = "simple", moves=None,
              device=None, on_step=None):
    """Play the demo's game on ``device`` (None: the card); returns the
    final state (a batch of one) and the steps played.  ``moves``
    ([steps, 4]) replaces the policy (dead agents' moves still zeroed);
    ``on_step(t, state, moves)`` sees each step's state and the moves
    that made it."""
    device = resolve_device(device)
    s = init_state_np(seed, device=device)
    s = s._replace(agent_can_kick=torch.ones_like(s.agent_can_kick))
    act = None if moves is not None else policy_moves(policy, seed, device)
    played = 0
    for t in range(steps):
        if moves is None:
            mv = act(s)
        else:
            mv = torch.as_tensor(moves[t]).to(device=device, dtype=I32)
            mv = torch.where(s.agent_dead, 0, mv.reshape(1, AGENT_COUNT))
        s = advance(s, mv)
        played += 1
        if on_step is not None:
            on_step(t, s, mv)
        if int(s.alive_count[0]) <= 1:
            break
    return s, played


def winner_line(s) -> str:
    """The demo's last line for the final state (a batch of one)."""
    alive = [i for i, d in enumerate(s.agent_dead[0].tolist()) if not d]
    if len(alive) == 1:
        return f"Finished! The winner is Agent {alive[0]}"
    if not alive:
        return "Draw! All agents are dead"
    return "Draw! Max timesteps reached"


def main(argv=None, moves=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0x1337)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--fps", type=float, default=12.0)
    p.add_argument("--policy", choices=POLICIES, default="simple")
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--pause", action="store_true",
                   help="step-by-step: wait for Enter")
    p.add_argument("--device", default=None,
                   help="cpu for the plain run on the CPU (default: the card)")
    args = p.parse_args(argv)

    def show(t, s, mv):
        if args.no_render:
            return
        print_state(state_of(s, 0), clear=True)
        if args.pause:
            input()
        else:
            time.sleep(1.0 / args.fps)

    s, _ = play_game(args.seed, args.steps, args.policy, moves, args.device,
                     on_step=show)
    print_state(state_of(s, 0), clear=False)
    print(winner_line(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())

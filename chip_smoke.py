#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build   -- compile ``pomcpp_tpu_torch/csrc`` with nvcc for sm_90a and
              print each kernel's ``-Xptxas -v`` registers, stack, spill and
              shared-memory bytes, and the warp-layout kernels' resident
              boards per SM as the CUDA runtime reports them;
2. step    -- the fused step kernel vs ``fused_step_plain``, bit for bit:
              every 6^4 joint move on a kick-heavy state and on a 2x2 ring
              of agents, 4096 boards with mixed kick stepped 50 steps with
              host-drawn moves, and ragged and tiny batches (1021, 5, 3, 1);
3. fsm     -- the SimpleAgent act kernel vs ``fsm_act_plain``, bit for bit
              (moves and the ten FSM arrays), the FSM state carried from act
              to act: 4096 generated boards stepped 30 acts, close-quarters
              boards, boards with dead agents, 6^4 copies of the kick-heavy
              state (bombs in range: danger map and flee path) and of the
              2x2 ring with none, agent 0 and agent 2 dead, two acts each,
              and ragged and tiny batches (1021, 5, 3, 1);
4. chunk   -- the chunk kernel vs ``rollout_chunk_plain``, bit for bit, at
              1024 boards x 64 steps: harmless and random once with injected
              moves, injected reset boards and record=True, once with
              in-kernel Philox draws and auto-reset; simple with injected
              rands + reset boards + record, with Philox draws + auto-reset,
              and with ``inject_slots=(0,)`` + ``prng_rand=True``; then
              every 6^4 joint move on a kick-heavy state (moving bombs) and
              on a 2x2 ring of agents (moves without a movement root), and
              ragged and tiny batches (1021, 5, 3 and 1 boards) of all three
              policies with Philox draws and auto-reset;
5. main    -- the main path at full width: 16384 boards from
              ``random_cell_state`` on the card, 256-step chunks of harmless,
              random, then simple self-play (a few chunks each, the FSM
              state carried across chunks), then a few single SimpleAgent
              steps of the whole batch (``fsm_act`` + ``fused_step``);
              launch counts are reset just before and read just after;
              state invariants checked;
6. timing  -- each kernel at the main path's shapes against its plain
              version on the same inputs (and their agreement there); the
              plain simple chunk runs 16 of the 256 steps; the chunk
              kernel's times are printed beside those of the layout it
              replaced; the act's entry point on a typed state is shown to
              call no PyTorch operator but allocations (every operator is
              recorded by a ``TorchDispatchMode``) and to launch
              ``fsm_act_kernel`` once;
7. env     -- the env layer.  Held, every ``EnvState`` field bit for bit
              between the card and the same call on CPU tensors (the plain
              versions), 1024 boards x 64 steps with resets, draws and wins:
              ``env_step_auto_reset_batch(fused=True)`` (the step and env
              kernel ``fused_step_kernel<true>``) with injected fresh
              boards, with the port's own Philox resets and
              ``randomize_positions``, in team mode, and from every board
              done; ``env_step_auto_reset_batch_fsm(learner_slots=(0,))``
              (the simple chunk, then ``env_merge_kernel``) with
              ``rand_moves``, with ``seed`` in team mode with
              ``randomize_positions``, and with injected fresh boards.
              Then its path at full width, 16384 boards from
              ``env_reset``: 256 fused env steps, 256 mixed-control env
              steps (three in-kernel SimpleAgents), each call's launches
              counted (one, and two) and a few calls run under
              ``torch.cuda.set_sync_debug_mode("error")`` (no host read),
              ``observe_ego`` for all four agents on 64 steps, and 64 steps
              of ``PommermanEnv(batch_size=1024, fog="ego")`` through
              numpy; launch counts reset before and read after; then the
              env kernels' device time against their plain versions, the
              merge's bytes per second (the bytes this run's done boards
              need) beside the memory rate and beside one device-to-device
              ``copy_`` of the same bytes;
8. probes  -- the five probe kernels: every pattern in both layouts against
              its plain version, bit for bit, on seeded inputs at a small
              loop count (and with ``rows=32``, and on a ragged row count),
              ``dot`` on random floats within its stated tolerance, then
              ``probes.run_report`` at the scripts' sizes (device time from
              a cold L2, each pattern beside its bound from the card's
              rates, ``device.card_rates``; launch counts reset before and
              read after), then every pattern's plain version at those
              sizes, timed and compared again, and the closed form of each
              pattern whose loop folds, as one PyTorch call; the phase
              fails if a pattern reads above 100% of its bound.

9. learn   -- the PPO learner.  Held, card against the same call on CPU
              tensors at the full-width runs' board counts, 8 steps with
              injected moves, fresh boards and FSM rands and a step cap of
              12 (resets, deaths and step-cap draws in the window):
              ``collect_rollout_batch`` against three in-kernel
              SimpleAgents (learner slot 0) at 2048 boards and in
              shared-policy self-play at 4096 boards, both
              ``fused_env=True``, each launch count exact -- the env and
              FSM state, features, moves, rewards and masks bit for bit,
              ``logp``, ``value`` and the bootstrap values within
              ``LEARN_TOL`` -- then one ``ppo_update`` of the self-play
              batch (4 contiguous minibatches of 32,768 rows, self-play's
              minibatch) from the same params, loss and each leaf's
              parameter change within ``LEARN_TOL``.  A few collector
              steps of each configuration
              run under ``set_sync_debug_mode("error")`` (no host read).
              Then its path at full width: the flagship recipe of
              docs/TRAINING.md:33-35 (2048 boards x 64 steps, 1 epoch, 2
              minibatches, learner slot 0 against SimpleAgents) for 1
              warm-up and 3 timed ``ppo_train_step`` iterations, and
              shared-policy self-play (4096 boards x 64 steps, 2 epochs, 8
              minibatches) for 1 and 2: env-steps/s with the metrics' host
              fetch inside the window, each iteration's port launches held
              to exactly 64 of its env kernels, one more iteration split by
              CUDA events into collect, GAE plus flatten and update, the
              kernels and copies per rollout step and the device's idle
              share from ``torch.profiler`` over a 4-step collect (an
              empty profiler session fails the phase), the peak device
              memory above what was allocated before the run, finite
              metrics and finished episodes; launch
              counts reset before and read after.  Last,
              ``artifacts/ppo_vs_simple`` in slot 0 against three in-kernel
              SimpleAgents, 1024 boards x 832 steps with no update, must win
              a larger share of its finished games than a fresh net.
10. search -- tree search, search distillation and the arena.  Held, card
              against the same call on CPU tensors with the same draws, at
              the full-width runs' 1024 boards wherever a kernel of the port
              runs: ``mcts_moves_chunk`` (6 sims, depth 12, tree depth 6)
              with exactly 42 ``rollout_chunk_kernel`` launches, bit for
              bit; the unguided ``collect_search_rollout`` for 2 steps (2
              sims, depth 12, tree depth 6, a step cap of 14), every field
              bit for bit and the launches exact (112 + 2); one update of its
              8,192 rows from the checkpoint within ``LEARN_TOL``;
              ``play_games(["ppo", "simple", "lazy", "random"])`` for 24
              steps from mid-game boards, ``GameResults`` and moves
              equal with the ppo slot's moves taken from the card's run (the
              free-running comparison is reported), 24 ``fsm_act_kernel``
              launches.  At 256 boards, the planners that launch no kernel
              of the port: ``mcts_moves`` and ``lookahead_moves`` (the
              uncapped plane engine on both sides), bit for bit;
              ``mcts_moves_net`` with ``artifacts/ppo_randseat``, root Q
              within ``NET_Q_TOL`` where the visits agree and at most
              ``NET_FLIP_SHARE`` of the boards' visits differing (each
              listed with its top-two gaps).  No host read in the unguided
              collector; the plane engine's host reads per step
              counted.  Then the path at full width, ``train_az.py``'s
              defaults (1024 boards x 8 steps, 16 sims, depth 12, tree depth
              6, the shipped model): unguided from a fresh net, 1 warm-up and
              2 timed ``az_train_step`` iterations, each holding exactly 3,584
              ``rollout_chunk_kernel`` and 8 ``fused_env_step_kernel``
              launches; guided from ``artifacts/ppo_randseat`` for one
              iteration of 2 env steps; env- and search-steps/s, each
              iteration split by CUDA events into search, features + env and
              update, peak memory above what was held before; one env step
              of each under ``torch.profiler`` in a child process
              (``--search-profile-child``; 4 sims unguided, 1 guided); then
              the arena: ``ppo,simple,simple,simple`` at 1024 games x 400
              steps with the checkpoint and with a fresh net (seat 0 must win
              a larger share of finished games with the checkpoint), and
              ``azmcts,simple,simple,simple`` (24 sims) at 64 games for 2
              steps.
11. dist   -- data parallel, resume and replays.  Two gloo ranks sharing
              the card, as two child processes (``--dist-child``): the
              sharded random and simple chunks (16384 boards x 256 steps,
              moves, rands and reset terrain injected, auto-reset) against
              the unsharded chunk on each rank's rows, bit for bit; one
              flagship PPO iteration (2048 boards x 64 steps, learner slot 0
              against three SimpleAgents, ``fused_env=True``, the shipped
              width) leaving both ranks' parameters and metrics
              bit-identical, then a timed iteration (each rank's
              env-steps/s) and one whose all-reduces are timed between
              syncs.  One NCCL rank (``--nccl-child``, deterministic
              algorithms): a flagship iteration through the data-parallel
              path against the plain path, bit for bit, and a sum over one
              rank against its input.  ``train_ppo`` at the flagship recipe
              (``--resume-child``): 2 iterations and a ``--resume`` to 4
              against 4 straight, with ``torch.use_deterministic_algorithms``
              and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (must match), then
              with the defaults (reported).  A 64-step game recorded on the
              card (``fused_step_kernel``, 1024 boards, board 0), saved and
              loaded: each frame's ``render_state`` against the same game
              stepped by the plain version on the CPU.  The launches of the
              sharded runs, the NCCL rank's data-parallel iteration and the
              recording count as the ``dist`` path's.
12. exact  -- the exact conformance engine (no kernel of its own).  Held,
              card against the same call on CPU tensors, every ``State``
              field bit for bit (every physical queue slot): 1024 reference
              boards (``init_states_np``, half with kick) x 64 random steps;
              every 6^4 joint move on the kick-heavy state and the 2x2 ring
              (``to_state``); ragged and tiny batches (1021, 5, 1); the exact
              SimpleAgent, 1024 boards x 32 acts of all four agents with
              injected rands (moves, consumed, agent state, and the exact
              steps of those moves); ``env_step_auto_reset`` on exact games,
              1024 x 64 with injected fresh boards.  Then the path at full
              width through ``divergence_census.run_census``: the random
              census at 10,000 games x 800 steps as one batch and the
              SimpleAgent census at 5,000 x 800, per-class counts and ppm
              beside BASELINE.md's JAX figures, 0 unclassified or the phase
              fails, game-steps/s and peak memory; a profiling child
              (``--exact-profile-child``) times one exact step at 10,000
              boards (ms, PyTorch operators, host reads, the device's idle
              share from ``torch.profiler``) and a census step's parts.
13. tooling -- the exact engine's tooling (no kernel of its own).  The state
              fuzzer at its script's size (``state_fuzz.find_snapshots``,
              ``fuzz_state``): n = 5, 15,625 two-step sequences a state in
              one batched call of two exact steps on the card, over as many
              of the script's 20 states as fit in ``FUZZ_SECONDS``, every
              sweep held card == CPU on every oracle dump (and against the
              compiled C++ oracle where ``tools/build_oracle.sh`` builds it;
              a line says which), sequences/s, the median sweep's ms and
              the peak memory; one ``play_demo`` game per policy (500 steps
              at most, the SimpleAgent's cut to ``DEMO_SIMPLE_STEPS``), every
              move and state held against the same game on the CPU, ms per
              step; a
              120-step random-policy ``replay_viewer`` recording on the card
              against the CPU's and its frames 10-14 from the npz;
              ``debug_divergence`` on one 500-board census batch with
              injected random moves, its report equal to the CPU's.  No
              kernel of the port may launch on this path.

``--profile`` builds, runs the env path at full width and then a
``torch.profiler`` pass over 32 fused and 32 mixed-control env steps, prints
the kernels and copies per step, the device idle share and the device time
by kernel; then it turns the port's tracing on and runs 16 chunks of each
policy at the main path's size, of which every 8th launches the chunk
kernel's clocked instance (``pomcpp_tpu_torch.trace``), holds the result to
16 chunks run with tracing off, and prints the share of each phase of a
step in the sampled calls' summed warp cycles and the sampled calls' device
time beside the others'.  It exits with code 4 and
no result line.
``--only=probes,env`` (any of step, fsm, chunk, env, probes, learn, search,
dist, exact, tooling) builds, runs just those held comparisons (for ``learn``,
``search``, ``dist``, ``exact`` and ``tooling``, the whole phase) and exits
with code 4 and no result line.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

BOARDS = 16384          # bench.py's batch
CHUNK = 256             # bench.py's steps per launch
MAIN_CHUNKS = 2         # chunks per policy on the main path
MAIN_STEPS = 4          # single fused steps on the main path
# The card's rates (memory; 32-bit instructions: 128 lanes x SMs x the
# maximum SM clock, read from the card) are pomcpp_tpu_torch.device.card_rates.
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor-core dense peak
STATE_BYTES = 7 * 121 * 4 + 7 * 4 * 4   # one board's 14 state arrays, int32
# One board's CellState in its own dtypes (bool as a byte) and the rest of
# its EnvState (done, winner, is_draw, key).
GAME_BYTES = 7 * 121 * 4 + 5 * 4 * 4 + 2 * 4 + 2 * 4
ENV_BYTES = 1 + 4 + 1 + 3 * 8
FSM_BYTES = 10 * 4 * 4                  # one board's ten FSM arrays
MOVE_BYTES = 4 * 4
# What one act reads and writes for a board: the planes board, bomb timer
# and bomb strength, agent x, y, bomb count, max bombs and the dead bytes,
# the FSM state in and out, the rands and the moves.
ACT_BYTES = 3 * 121 * 4 + 4 * 4 * 4 + 4 + 2 * FSM_BYTES + 2 * MOVE_BYTES
# What env_merge_kernel moves for a board, its stepped game written in place:
# a running board reads its EnvState, dead bytes, alive_count and timestep
# and writes its EnvState; a done board reads its done byte and key and
# writes a fresh game and its EnvState.
MERGE_RUNNING_BYTES = 2 * ENV_BYTES + 4 + 4 + 4
MERGE_DONE_BYTES = 1 + 3 * 8 + GAME_BYTES + ENV_BYTES
PLAIN_SIMPLE_STEPS = 16   # steps of the plain simple chunk in the timing
ENV_HELD_BOARDS, ENV_HELD_STEPS = 1024, 64
ENV_STEPS = 256           # fused and mixed-control env steps at full width
ENV_OBS_STEPS = 64        # steps with observe_ego for all four agents
GYM_BOARDS, GYM_STEPS = 1024, 64
PROBE_HELD_ROWS, PROBE_HELD_K = 512, 3
PROBE_ROWS = 16384        # the scripts' 128 blocks x 128 rows
# Chunk kernel ms at BOARDS x CHUNK in the layout of one board per CTA, as
# PERF.md records them (an NVIDIA H100 80GB HBM3 at 700.00 W).
CTA_LAYOUT_MS = {"harmless": 52.25, "random": 78.629, "simple": 130.949}
# Before the env kernels (PERF.md, same card): ms per env step at 16384
# boards, and the one-step kernel of one board per CTA.
ENV_STEP_MS_BEFORE = {"fused": 4.163, "fsm": 4.339}
STEP_KERNEL_MS_BEFORE = 0.253
# Before their redesign (PERF.md, same card): device ms of the act kernel of
# one board per CTA and of the merge on the lane layout, at 16384 boards.
ACT_KERNEL_MS_BEFORE = 0.156
MERGE_KERNEL_MS_BEFORE = 0.0955


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kick_heavy_state(device):
    """Kick-enabled agents around two bombs (the 6^4 sweep's state)."""
    import torch

    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    cs = empty_cell_state(1, device)
    board = cs.board.clone()
    bt, bs, bo = (cs.bomb_timer.clone(), cs.bomb_strength.clone(),
                  cs.bomb_owner.clone())
    for i, (x, y) in enumerate(((4, 5), (6, 5), (5, 4), (5, 6))):
        board[0, x + 11 * y] = 10 + i
    for owner, (x, y), life in ((0, (5, 5), 6), (1, (3, 5), 9)):
        c = x + 11 * y
        board[0, c], bt[0, c], bs[0, c], bo[0, c] = 3, life, 1, owner
    i32 = dict(dtype=torch.int32, device=device)
    return cs._replace(
        board=board, bomb_timer=bt, bomb_strength=bs, bomb_owner=bo,
        agent_x=torch.tensor([[4, 6, 5, 5]], **i32),
        agent_y=torch.tensor([[5, 5, 4, 6]], **i32),
        agent_bomb_count=torch.tensor([[1, 1, 0, 0]], **i32),
        agent_can_kick=torch.ones((1, 4), dtype=torch.bool, device=device),
    )


def ring_state(device, dead=()):
    """Four agents on a 2x2 square (a ring of moves without a movement
    root), ``dead`` of them dead."""
    import torch

    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    one = empty_cell_state(1, device)
    board = one.board.clone()
    ring = ((4, 4), (5, 4), (5, 5), (4, 5))
    for i, (x, y) in enumerate(ring):
        board[0, x + 11 * y] = 10 + i
    gone = torch.tensor([[i in dead for i in range(4)]], device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return kill(one._replace(
        board=board, agent_x=torch.tensor([[x for x, _ in ring]], **i32),
        agent_y=torch.tensor([[y for _, y in ring]], **i32)), gone)


def _need_game(device, agents, dead=(), rigid=(), bombs=(), loops=()):
    """One board: the four agents at ``agents`` (the dead ones off the
    board), rigid walls at ``rigid``, bombs ``(x, y, timer, strength,
    owner)``; and its FSM state, every ring four distinct cells but the
    agents in ``loops``, whose rings repeat."""
    import torch

    from pomcpp_tpu_torch.agents.simple import FsmState
    from pomcpp_tpu_torch.engine.cellular import empty_cell_state

    cs = empty_cell_state(1, device)
    board, bt, bs, bo = (cs.board.clone(), cs.bomb_timer.clone(),
                         cs.bomb_strength.clone(), cs.bomb_owner.clone())
    count = [0] * 4
    for x, y in rigid:
        board[0, x + 11 * y] = 1
    for x, y, timer, strength, owner in bombs:
        c = x + 11 * y
        board[0, c], bt[0, c], bs[0, c], bo[0, c] = 3, timer, strength, owner
        count[owner] += 1
    for i, (x, y) in enumerate(agents):
        if i not in dead:
            board[0, x + 11 * y] = 10 + i
    i32 = dict(dtype=torch.int32, device=device)
    gone = torch.tensor([[i in dead for i in range(4)]], device=device)
    cs = kill(cs._replace(
        board=board, bomb_timer=bt, bomb_strength=bs, bomb_owner=bo,
        agent_x=torch.tensor([[x for x, _ in agents]], **i32),
        agent_y=torch.tensor([[y for _, y in agents]], **i32),
        agent_bomb_count=torch.tensor([count], **i32)), gone)
    ring = [[15 + k + 13 * i if i not in loops else (20, 21)[k % 2]
             for i in range(4)] for k in range(4)]
    zero = torch.zeros((1, 4), **i32)
    fsm = FsmState(*(torch.tensor([r], **i32) for r in ring), zero,
                   torch.full((1, 4), 4, **i32), zero, zero, zero, zero)
    return cs, fsm


def bfs_need_states(device) -> dict:
    """One-board states that fix whether the SimpleAgent's BFS runs
    (``wl::fsm_act``): name -> (CellState, FSM state, learner slots injected,
    acts that run a BFS round, BFS rounds after an act's first).  Only a
    live agent in danger with an enterable safe cell in its flee window, or
    one that would step toward an enemy within 7 (can bomb, none within 1,
    no loop in its ring), needs the BFS; an act that runs it runs it until
    no field changes."""
    corners = ((0, 0), (10, 0), (0, 10), (10, 10))
    wall = tuple((2, y) for y in range(10))
    # Agent `who` at (1, 1) in the danger of a bomb below it; one other
    # agent alive, at (10, 10).
    def flee(timer, who=0, rigid=()):
        others = iter(((10, 10), (10, 0), (0, 10)))
        agents = tuple((1, 1) if i == who else next(others) for i in range(4))
        live = agents.index((10, 10))
        return _need_game(device, agents,
                          dead=tuple(i for i in range(4) if i not in (who, live)),
                          rigid=rigid, bombs=((1, 2, timer, 1, live),))

    return {
        # Four calm agents 10 or more apart: no round at all.
        "no_need": _need_game(device, corners) + ((), 0, 0),
        # Agent 2's window of radius 2: (0, 0) alone is enterable and safe,
        # and walled off; the BFS runs until no field changes.
        "flee_walled": flee(2, who=2, rigid=((1, 0), (0, 1))) + ((), 1, 18),
        # Window of radius 3, its cells all within 2 steps: the BFS still
        # runs until no field changes.
        "flee_near": flee(3) + ((), 1, 20),
        # Agent 0 in danger at (8, 8): its window (x and y below the radius)
        # holds no cell, so no round runs.
        "flee_no_window": _need_game(device, ((8, 8), (0, 0), (10, 0), (0, 10)),
                                     dead=(2, 3), bombs=((8, 9, 3, 1, 1),))
        + ((), 0, 0),
        # Agents 0 and 1 four apart across a wall: the way round is 14 steps,
        # and the BFS runs until no field changes.
        "enemy_detour": _need_game(device, ((0, 5), (4, 5), (10, 0), (10, 10)),
                                   rigid=wall) + ((), 1, 30),
        # The same, but their rings loop: they take b2, not the BFS's move.
        "enemy_loop": _need_game(device, ((0, 5), (4, 5), (10, 0), (10, 10)),
                                 rigid=wall, loops=(0, 1)) + ((), 0, 0),
        # Agents 0 and 1 side by side: both bomb (b1).
        "enemy_adjacent": _need_game(device, ((4, 5), (5, 5), (10, 0), (10, 10)))
        + ((), 0, 0),
        # Dead agent 2 in a bomb's cross next to agent 0, which is calm.
        "dead_in_danger": _need_game(device, ((5, 5), (0, 0), (6, 5), (10, 10)),
                                     dead=(2, 3), bombs=((7, 5, 5, 1, 1),))
        + ((), 0, 0),
        # Learner slot 0 injected: the FSM still acts, and needs, for it.
        "slot0_injected": flee(3) + ((0,), 1, 20),
    }


FEATURE_EDGES = ((0, 0), (10, 0), (0, 10), (10, 10), (5, 0), (0, 5),
                 (10, 5), (5, 10), (1, 9), (9, 1), (5, 5))


def feature_states(device, b: int, seed: int = 0) -> dict:
    """Games the feature kernel is held on, ``b`` boards each: fresh ones,
    ones after 24 random steps (bombs, flames, kicks, deaths) and after 60
    SimpleAgent steps, and the random ones with their agents set on every
    edge and corner of the board."""
    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import rollout_chunk_plain
    from pomcpp_tpu_torch.env.environment import env_reset

    gen = torch.Generator(device=device).manual_seed(seed)
    cs = random_cell_state(b, generator=gen)
    cs = cs._replace(agent_can_kick=torch.rand(
        (b, 4), generator=gen, device=device) < 0.5)
    random = rollout_chunk_plain(cs, seed, 24, "random", auto_reset=False)
    reset = env_reset(seed, b, device=device).game
    simple = rollout_chunk_plain(
        reset, seed + 1, 60, "simple", auto_reset=False,
        fsm_state=simple_fsm_state_init(b, device))[0]
    spot = torch.arange(4 * b, device=device).reshape(b, 4) % len(FEATURE_EDGES)
    xy = torch.tensor(FEATURE_EDGES, dtype=torch.int32, device=device)[spot]
    edges = random._replace(agent_x=xy[..., 0].contiguous(),
                            agent_y=xy[..., 1].contiguous())
    return {"reset": reset, "random": random, "simple": simple,
            "edges": edges}


def copies(cs, n):
    """``n`` copies of a one-board state."""
    return type(cs)(*(t.expand((n,) + t.shape[1:]).contiguous() for t in cs))


def max_abs_err(a, b) -> int:
    """Largest absolute difference over every CellState field."""
    return max(
        int((x.long() - y.long()).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def expect_equal(what: str, a, b) -> int:
    from pomcpp_tpu_torch.convert import diff_fields

    bad = diff_fields(a, b, skip=())
    if bad:
        raise AssertionError(f"{what}: kernel and plain version differ in {bad}")
    return max_abs_err(a, b)


def expect_fsm_equal(what: str, a, b) -> int:
    """Moves or FSM arrays: exact equality; returns the max abs error (0)."""
    import torch

    for k, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel and plain differ in array {k}")
    return 0


def close_quarters(cs, gen):
    """All four agents moved onto distinct cells of a random 5x5 window."""
    import torch

    b, dev = cs.board.shape[0], cs.board.device
    rows = torch.arange(b, device=dev)
    board = cs.board.clone()
    for i in range(4):
        board[rows, cs.agent_x[:, i] + 11 * cs.agent_y[:, i]] = 0
    origin = torch.randint(0, 7, (b, 2), generator=gen, device=dev)
    cells = torch.rand((b, 25), generator=gen, device=dev).argsort(1)[:, :4]
    ax = (origin[:, :1] + cells % 5).int()
    ay = (origin[:, 1:] + cells // 5).int()
    for i in range(4):
        board[rows, ax[:, i] + 11 * ay[:, i]] = 10 + i
    return cs._replace(board=board, agent_x=ax, agent_y=ay)


def kill(cs, dead):
    import torch

    return cs._replace(agent_dead=dead,
                       alive_count=4 - dead.sum(1, dtype=torch.int32))


def check_invariants(cs) -> None:
    import torch

    x, y = cs.agent_x.long(), cs.agent_y.long()
    assert ((x >= 0) & (x < 11) & (y >= 0) & (y < 11)).all(), "position off board"
    assert torch.equal(cs.alive_count, 4 - cs.agent_dead.sum(1, dtype=torch.int32))
    code = cs.board.gather(1, x + 11 * y)
    ids = torch.arange(4, device=code.device) + 10
    assert ((code == ids) | cs.agent_dead).all(), "live agent's cell lacks its code"
    b = cs.board
    valid = (b >= 0) & (b <= 13) & (b != 5) & (b != 9)
    assert valid.all(), "invalid cell code"
    bc, mb = cs.agent_bomb_count, cs.agent_max_bombs
    assert ((bc >= 0) & (bc <= mb)).all(), "bomb count out of range"


ENGINE_KERNELS = ("fused_step_kernel", "rollout_chunk_kernel",
                  "rollout_chunk_simple_kernel", "fsm_act_kernel")
ENV_KERNELS = ("fused_env_step_kernel", "env_merge_kernel",
               "rollout_chunk_simple_kernel")
PROBE_KERNELS = ("probe_elem_kernel", "probe_shift_kernel",
                 "probe_reduce_kernel", "probe_dot_kernel",
                 "probe_dot_tc_kernel")


def expect_launched(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on {path}")


class Timer:
    """CUDA-event timing of work on the current stream."""

    def __init__(self):
        import torch

        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


KERNEL_ENTRIES = (("rollout_chunk_kernelILb1", "rollout_chunk_simple_kernel"),
                  ("rollout_chunk_kernelILb0", "rollout_chunk_kernel"),
                  ("rollout_chunk_clocked_kernelILb1",
                   "rollout_chunk_clocked_simple_kernel"),
                  ("rollout_chunk_clocked_kernelILb0",
                   "rollout_chunk_clocked_kernel"),
                  ("fsm_act_kernel", "fsm_act_kernel"),
                  ("fused_step_kernelILb1", "fused_env_step_kernel"),
                  ("fused_step_kernelILb0", "fused_step_kernel"),
                  ("env_merge_kernel", "env_merge_kernel"),
                  ("ego_features_kernel", "ego_features_kernel"),
                  ("probe_elem_dense_kernel", "probe_elem_kernel (warp)"),
                  ("probe_shift_warp_kernel", "probe_shift_kernel (warp)"),
                  ("probe_shift_agents_kernel", "probe_shift_kernel (warp)"),
                  ("probe_reduce_warp_kernel", "probe_reduce_kernel (warp)"),
                  ("probe_reduce_agents_kernel", "probe_reduce_kernel (warp)"),
                  ("probe_lookup_warp_kernel", "probe_reduce_kernel (warp)"),
                  ("probe_any4_warp_kernel", "probe_reduce_kernel (warp)"),
                  ("probe_dotred_warp_kernel", "probe_dot_kernel (warp)"),
                  ("probe_elem_kernel", "probe_elem_kernel"),
                  ("probe_shift_kernel", "probe_shift_kernel"),
                  ("probe_reduce_", "probe_reduce_kernel"),
                  ("probe_dot_tc_kernel", "probe_dot_tc_kernel"),
                  ("probe_dot_kernel", "probe_dot_kernel"))
# The kernels of fused_step.cu (one board per warp), by their index in
# pomcpp_ctas_per_sm.
WARP_LAYOUT_KERNELS = ("rollout_chunk_kernel", "rollout_chunk_simple_kernel",
                       "fused_step_kernel", "fused_env_step_kernel",
                       "env_merge_kernel", "fsm_act_kernel",
                       "rollout_chunk_clocked_kernel",
                       "rollout_chunk_clocked_simple_kernel")


def kernel_resources(build_log: str) -> dict:
    """Per kernel, from nvcc's -Xptxas -v log: registers per thread, bytes of
    stack frame, of spill stores and loads, and of static shared memory.  A
    probe kernel has one entry per pattern and layout: the most of each."""
    res, current = {}, None
    for line in build_log.splitlines():
        if "entry function" in line:
            current = next((n for key, n in KERNEL_ENTRIES if key in line), None)
            continue
        if not current:
            continue
        row = res.setdefault(current, dict(registers=0, stack_bytes=0,
                                           spill_store_bytes=0,
                                           spill_load_bytes=0, smem_bytes=0))

        def most(key, text, before):
            row[key] = max(row[key], int(text.split(before)[0].split()[-1]))

        if "bytes stack frame" in line:
            most("stack_bytes", line, "bytes stack frame")
            most("spill_store_bytes", line, "bytes spill stores")
            most("spill_load_bytes", line, "bytes spill loads")
        elif "registers" in line:
            row["registers"] = max(row["registers"],
                                   int(line.split("Used")[1].split()[0]))
            if "bytes smem" in line:
                most("smem_bytes", line, "bytes smem")
            current = None
    return res


def warp_residency(res: dict, lib) -> dict:
    """Add to the warp-layout kernels' rows of ``res`` what the CUDA runtime
    says of their residency, for the launch configuration the launchers
    use: one board per warp."""
    warps = lib.pomcpp_chunk_warps()
    for k, name in enumerate(WARP_LAYOUT_KERNELS):
        ctas = lib.pomcpp_ctas_per_sm(k)
        if ctas <= 0:
            raise RuntimeError(f"{name}: no CTA fits on an SM ({ctas})")
        res.setdefault(name, {}).update(
            warps_per_cta=warps, ctas_per_sm=ctas, boards_per_sm=ctas * warps)
    return res


def phase_build():
    from pomcpp_tpu_torch import _ext

    ver = subprocess.run([_ext.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[build] {ver[-1]}")
    t0 = time.perf_counter()
    _ext.build()            # one nvcc per source file, started together
    lib = _ext.lib()
    _ext.probes_lib()
    _ext.features_lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    # The compiler's log is kept beside each library, so a run that finds
    # them built reports the same resources as the run that built them.
    res = warp_residency(kernel_resources(_ext.build_log()), lib)
    for name, row in res.items():
        log(f"[build] {name}: {json.dumps(row)}")
    for line in _ext.build_log().splitlines():   # e.g. serialized wgmma
        if "Performance" in line or "wgmma" in line:
            log(f"[build] ptxas: {line.strip()}")
    return res


def phase_step(dev):
    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fused_step import fused_step, fused_step_plain

    n = 6 ** 4
    codes = torch.arange(n, device=dev)
    moves = torch.stack([(codes // 6 ** i) % 6 for i in range(4)], 1).int()
    csb = copies(kick_heavy_state(dev), n)
    for depth in range(2):
        k = fused_step(csb, moves, device=dev)
        p = fused_step_plain(csb, moves)
        expect_equal(f"step sweep depth {depth}", k, p)
        csb = p
    for gone in ((), (0,), (2,)):
        csb = copies(ring_state(dev, gone), n)
        expect_equal(f"step ring sweep dead={gone}",
                     fused_step(csb, moves, device=dev),
                     fused_step_plain(csb, moves))
    log("[step] 6^4 joint-move sweeps: kick-heavy state (2 steps deep), 2x2 "
        "ring with none, agent 0 and agent 2 dead: kernel == plain")

    b = 4096
    gen = torch.Generator(device=dev).manual_seed(11)
    cs = random_cell_state(b, generator=gen)
    cs = cs._replace(agent_can_kick=torch.rand((b, 4), generator=gen,
                                               device=dev) < 0.5)
    k = p = cs
    for t in range(50):
        mv = torch.randint(0, 6, (b, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        k = fused_step(k, mv, device=dev)
        p = fused_step_plain(p, mv)
        expect_equal(f"step batch t={t}", k, p)
    log(f"[step] {b} boards x 50 steps, mixed kick: kernel == plain "
        f"({int(p.agent_dead.sum())} agents dead at the end)")

    # Ragged and tiny batches: the last CTA of four warps partly or mostly
    # without a board.
    for b in (1021, 5, 3, 1):
        k = p = close_quarters(random_cell_state(b, generator=gen), gen)
        for t in range(24):
            mv = torch.randint(0, 6, (b, 4), generator=gen, device=dev,
                               dtype=torch.int32)
            k = fused_step(k, mv, device=dev)
            p = fused_step_plain(p, mv)
            expect_equal(f"step {b} boards t={t}", k, p)
    log("[step] ragged: 1021, 5, 3 and 1 boards x 24 steps: kernel == plain")


def phase_fsm(dev):
    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import (
        fsm_act,
        fsm_act_plain,
        simple_fsm_state_init,
    )
    from pomcpp_tpu_torch.engine.fused_step import fused_step_plain

    gen = torch.Generator(device=dev).manual_seed(31)

    def run(what, cs, acts):
        b = cs.board.shape[0]
        fk = fp = simple_fsm_state_init(b, dev)
        for t in range(acts):
            rand = torch.randint(0, 5, (b, 4), generator=gen, device=dev,
                                 dtype=torch.int32)
            mk, fk = fsm_act(cs, fk, rand, device=dev)
            mp, fp = fsm_act_plain(cs, fp, rand)
            expect_fsm_equal(f"fsm {what} act {t}", (mk,) + fk, (mp,) + fp)
            cs = fused_step_plain(cs, torch.where(cs.agent_dead, 0, mp))
        log(f"[fsm] {what}: {b} boards x {acts} acts: kernel == plain "
            f"({int(cs.agent_dead.sum())} agents dead at the end)")

    run("generated", random_cell_state(4096, generator=gen), 30)
    run("close quarters", close_quarters(random_cell_state(1024, generator=gen),
                                         gen), 30)
    cs = close_quarters(random_cell_state(1024, generator=gen), gen)
    dead = torch.rand((1024, 4), generator=gen, device=dev) < 0.4
    run("dead agents", kill(cs, dead), 30)
    # Bombs in range (danger map, flee path) and rings with dead agents.
    run("kick-heavy state", copies(kick_heavy_state(dev), 6 ** 4), 2)
    for gone in ((), (0,), (2,)):
        run(f"2x2 ring dead={gone}", copies(ring_state(dev, gone), 6 ** 4), 2)
    # Ragged and tiny batches: the last CTA of four warps partly or mostly
    # without a board.
    for b in (1021, 5, 3, 1):
        run(f"ragged {b}", close_quarters(random_cell_state(b, generator=gen),
                                          gen), 6)


def phase_chunk(dev):
    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import (
        rollout_chunk,
        rollout_chunk_plain,
    )

    b, steps = 1024, 64
    gen = torch.Generator(device=dev).manual_seed(21)
    for policy, n_moves in (("harmless", 5), ("random", 6)):
        cs = random_cell_state(b, generator=gen)
        dead = torch.zeros((b, 4), dtype=torch.bool, device=dev)
        dead[: b // 8, 1:] = True           # finished at entry
        dead[b // 8: b // 4, 2:] = True     # two agents left
        cs = cs._replace(
            agent_dead=dead,
            alive_count=4 - dead.sum(1, dtype=torch.int32),
            agent_can_kick=torch.rand((b, 4), generator=gen, device=dev) < 0.3,
        )
        moves = torch.randint(0, n_moves, (steps, b, 4), generator=gen,
                              device=dev, dtype=torch.int32)
        fresh = random_cell_state(b, generator=gen)
        reset = (fresh.board, fresh.hidden_pow)
        k = rollout_chunk(cs, 3, steps, policy, moves=moves, record=True,
                          reset_boards=reset, device=dev)
        p = rollout_chunk_plain(cs, 3, steps, policy, moves=moves,
                                record=True, reset_boards=reset)
        expect_equal(f"chunk {policy} injected", k[0], p[0])
        assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
        log(f"[chunk] {policy}: injected moves + reset boards + record, "
            f"{b} x {steps}: kernel == plain ({int(p[2].sum())} done marks)")

        k = rollout_chunk(cs, 99, steps, policy, record=True, device=dev)
        p = rollout_chunk_plain(cs, 99, steps, policy, record=True)
        expect_equal(f"chunk {policy} philox", k[0], p[0])
        assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
        assert int(k[1].min()) == 0 and int(k[1].max()) == n_moves - 1
        log(f"[chunk] {policy}: in-kernel Philox draws + auto-reset, "
            f"{b} x {steps}: kernel == plain")

    cs = close_quarters(random_cell_state(b, generator=gen), gen)
    dead = torch.zeros((b, 4), dtype=torch.bool, device=dev)
    dead[: b // 8, 1:] = True           # finished at entry
    dead[b // 8: b // 4, :2] = True     # stale sources of dead agents
    cs = kill(cs, dead)
    fsm = simple_fsm_state_init(b, dev)
    fresh = random_cell_state(b, generator=gen)
    reset = (fresh.board, fresh.hidden_pow)
    rands = torch.randint(0, 5, (steps, b, 4), generator=gen, device=dev,
                          dtype=torch.int32)
    learner = torch.randint(0, 6, (steps, b, 4), generator=gen, device=dev,
                            dtype=torch.int32)
    cases = (
        ("injected rands + reset boards + record", 3,
         dict(moves=rands, reset_boards=reset)),
        ("in-kernel Philox draws + auto-reset", 99, {}),
        ("inject_slots=(0,) + prng_rand", 7,
         dict(moves=learner, inject_slots=(0,), prng_rand=True)),
    )
    for what, seed, kw in cases:
        k = rollout_chunk(cs, seed, steps, "simple", record=True,
                          fsm_state=fsm, device=dev, **kw)
        p = rollout_chunk_plain(cs, seed, steps, "simple", record=True,
                                fsm_state=fsm, **kw)
        expect_equal(f"chunk simple {what}", k[0], p[0])
        expect_fsm_equal(f"chunk simple {what}", k[1:3] + k[3], p[1:3] + p[3])
        log(f"[chunk] simple: {what}, {b} x {steps}: kernel == plain "
            f"({int(p[2].sum())} done marks)")

    # Moving bombs are rare in random play: every 6^4 joint move on the
    # kick-heavy state, then a few random steps, with the moves injected.
    n, steps = 6 ** 4, 6
    codes = torch.arange(n, device=dev)
    moves = torch.randint(0, 6, (steps, n, 4), generator=gen, device=dev,
                          dtype=torch.int32)
    moves[0] = torch.stack([(codes // 6 ** i) % 6 for i in range(4)], 1).int()
    cs = copies(kick_heavy_state(dev), n)
    for policy, kw in (
        ("random", {}),
        ("simple", dict(fsm_state=simple_fsm_state_init(n, dev),
                        inject_slots=(0, 1, 2, 3), prng_rand=True)),
    ):
        k = rollout_chunk(cs, 5, steps, policy, moves=moves, record=True,
                          auto_reset=False, device=dev, **kw)
        p = rollout_chunk_plain(cs, 5, steps, policy, moves=moves,
                                record=True, auto_reset=False, **kw)
        expect_equal(f"chunk {policy} kick sweep", k[0], p[0])
        expect_fsm_equal(f"chunk {policy} kick sweep",
                         k[1:3] + tuple(k[3:4] and k[3]),
                         p[1:3] + tuple(p[3:4] and p[3]))
        rolling = int(((p[0].bomb_dir != 0) & (p[0].bomb_timer > 0)).sum())
        assert rolling > 0, "the kick sweep left no bomb moving"
        log(f"[chunk] {policy}: 6^4 joint-move sweep on the kick-heavy state, "
            f"{steps} steps: kernel == plain ({rolling} bombs still moving)")

    # Four agents on a 2x2 square, every joint move: the rings without a
    # movement root, with all four alive and with one dead.
    for gone in ((), (2,)):
        cs = copies(ring_state(dev, gone), n)
        k = rollout_chunk(cs, 5, 2, "random", moves=moves[:2], record=True,
                          auto_reset=False, device=dev)
        p = rollout_chunk_plain(cs, 5, 2, "random", moves=moves[:2],
                                record=True, auto_reset=False)
        expect_equal(f"chunk ring sweep dead={gone}", k[0], p[0])
        expect_fsm_equal(f"chunk ring sweep dead={gone}", k[1:3], p[1:3])
    log("[chunk] random: 6^4 joint-move sweep on a 2x2 ring of agents, all "
        "alive and one dead, 2 steps: kernel == plain")

    # Ragged and tiny batches: the last CTA of four warps is partly or
    # mostly without a board.
    for b, steps in ((1021, 48), (5, 24), (3, 24), (1, 24)):
        cs = close_quarters(random_cell_state(b, generator=gen), gen)
        cs = cs._replace(agent_can_kick=torch.rand((b, 4), generator=gen,
                                                   device=dev) < 0.5)
        fsm = simple_fsm_state_init(b, dev)
        for policy in ("harmless", "random", "simple"):
            kw = dict(fsm_state=fsm) if policy == "simple" else {}
            k = rollout_chunk(cs, 40 + b, steps, policy, record=True,
                              device=dev, **kw)
            p = rollout_chunk_plain(cs, 40 + b, steps, policy, record=True,
                                    **kw)
            expect_equal(f"chunk {policy} {b} boards", k[0], p[0])
            expect_fsm_equal(f"chunk {policy} {b} boards",
                             k[1:3] + tuple(k[3:4] and k[3]),
                             p[1:3] + tuple(p[3:4] and p[3]))
        log(f"[chunk] ragged: {b} boards x {steps} steps, harmless, random "
            f"and simple, Philox draws + auto-reset: kernel == plain")


def phase_main(dev):
    """The main path at full width; returns timings and launch counts."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import fsm_act, simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import (
        draw_moves,
        fused_step,
        rollout_chunk,
    )

    cs = random_cell_state(BOARDS, seed=0)
    fsm = simple_fsm_state_init(BOARDS)
    # Warm-up chunks outside the counted run (first launch, lazy init), two
    # in a row so that the allocator already holds a second set of output
    # arrays: a chunk is short enough now for a cudaMalloc to show in it.
    warm = rollout_chunk(rollout_chunk(cs, 1, 8, "harmless"), 2, 8, "harmless")
    warm = rollout_chunk(warm, 1, 8, "simple", fsm_state=fsm)
    warm = rollout_chunk(warm[0], 2, 8, "simple", fsm_state=warm[1])
    torch.cuda.synchronize()
    del warm

    _ext.reset_launches()
    res = {"chunk_ms": {}, "steps_per_s": {}}
    inputs = {}
    seed = 100
    for policy in ("harmless", "random", "simple"):
        inputs[policy] = (cs, seed, fsm)
        times = []
        t0 = time.perf_counter()
        for _ in range(MAIN_CHUNKS):
            with Timer() as tm:
                if policy == "simple":
                    cs, fsm = rollout_chunk(cs, seed, CHUNK, policy,
                                            fsm_state=fsm)
                else:
                    cs = rollout_chunk(cs, seed, CHUNK, policy)
            times.append(tm)
            seed += 1
        int(cs.alive_count.sum())  # host fetch = real barrier
        wall = time.perf_counter() - t0
        res["chunk_ms"][policy] = [t.ms() for t in times]
        res["steps_per_s"][policy] = BOARDS * CHUNK * MAIN_CHUNKS / wall
        check_invariants(cs)
        log(f"[main] {policy}: {BOARDS} boards x {CHUNK} steps x "
            f"{MAIN_CHUNKS} chunks: {res['steps_per_s'][policy]:.0f} steps/s, "
            f"chunk kernel ms {[round(t, 3) for t in res['chunk_ms'][policy]]}")
    assert ((fsm.rp_count >= 0) & (fsm.rp_count <= 4)).all(), "ring count"
    # Single SimpleAgent steps: one act kernel + one step kernel each.
    step_times, act_times = [], []
    rand = draw_moves(seed, 0, BOARDS, 5, dev)
    inputs["step"] = (cs, draw_moves(seed, 0, BOARDS, 6, dev))
    inputs["fsm"] = (cs, fsm, rand)
    for t in range(MAIN_STEPS):
        rand = draw_moves(seed, t, BOARDS, 5, dev)
        with Timer() as ta:
            mv, fsm = fsm_act(cs, fsm, rand)
        with Timer() as tm:
            cs = fused_step(cs, torch.where(cs.agent_dead, 0, mv))
        step_times.append(tm)
        act_times.append(ta)
    int(cs.alive_count.sum())
    check_invariants(cs)
    res["step_ms"] = [t.ms() for t in step_times]
    res["act_ms"] = [t.ms() for t in act_times]
    res["launches"] = dict(_ext.LAUNCHES)
    log(f"[main] fsm_act + fused_step: {BOARDS} boards x {MAIN_STEPS} steps, "
        f"CUDA events around each call: act ms "
        f"{[round(t, 3) for t in res['act_ms']]}, step ms "
        f"{[round(t, 3) for t in res['step_ms']]}")
    log(f"[main] launches: {res['launches']}")
    expect_launched(res["launches"], ENGINE_KERNELS, "the main path")
    return res, inputs


def phase_timing(inputs):
    """Each kernel and its plain version on the main path's inputs."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.engine.fsm import fsm_act, fsm_act_plain
    from pomcpp_tpu_torch.engine.fused_step import (
        fused_step,
        fused_step_plain,
        rollout_chunk,
        rollout_chunk_plain,
    )

    out = {}
    cs, seed, _ = inputs["random"]
    with Timer() as tk:
        k = rollout_chunk(cs, seed, CHUNK, "random")
    with Timer() as tp:
        p = rollout_chunk_plain(cs, seed, CHUNK, "random")
    out["chunk"] = (tk.ms(), tp.ms(), expect_equal("main chunk", k, p))
    log(f"[timing] chunk {BOARDS} x {CHUNK} random: kernel {tk.ms():.3f} ms, "
        f"plain {tp.ms():.3f} ms, kernel == plain")

    cs, mv = inputs["step"]
    fused_step(cs, mv)
    reps = 20
    with Timer() as tk:
        for _ in range(reps):
            k = fused_step(cs, mv)
    with Timer() as tp:
        p = fused_step_plain(cs, mv)
    kernel_ms = device_ms(lambda: fused_step(cs, mv), reps)
    out["step"] = (kernel_ms, tp.ms(), expect_equal("main step", k, p),
                   tk.ms() / reps)
    log(f"[timing] step {BOARDS}: kernel {kernel_ms:.4f} ms (device; "
        f"{STEP_KERNEL_MS_BEFORE} ms one board per CTA), entry point "
        f"{tk.ms() / reps:.3f} ms, plain {tp.ms():.3f} ms, kernel == plain")

    cs, seed, fsm = inputs["simple"]
    with Timer() as tk:
        rollout_chunk(cs, seed, CHUNK, "simple", fsm_state=fsm)
    n = PLAIN_SIMPLE_STEPS
    k = rollout_chunk(cs, seed, n, "simple", fsm_state=fsm)
    with Timer() as tp:
        p = rollout_chunk_plain(cs, seed, n, "simple", fsm_state=fsm)
    err = expect_equal("main simple chunk", k[0], p[0])
    err = max(err, expect_fsm_equal("main simple chunk FSM", k[1], p[1]))
    out["simple"] = (tk.ms(), tp.ms(), err)
    log(f"[timing] simple chunk {BOARDS} x {CHUNK}: kernel {tk.ms():.3f} ms; "
        f"plain {BOARDS} x {n}: {tp.ms():.3f} ms; kernel == plain at "
        f"{BOARDS} x {n}")

    cs, fsm, rand = inputs["fsm"]
    before = dict(_ext.LAUNCHES)
    ops = device_ops(lambda: fsm_act(cs, fsm, rand))
    launched = launches_per_call(before, 1)
    if ops or launched != {"fsm_act_kernel": 1.0}:
        raise AssertionError(f"fsm_act ran {ops} and launched {launched}")
    with Timer() as tk:
        for _ in range(reps):
            k = fsm_act(cs, fsm, rand)
    with Timer() as tp:
        p = fsm_act_plain(cs, fsm, rand)
    kernel_ms = device_ms(lambda: fsm_act(cs, fsm, rand), reps)
    out["fsm"] = (kernel_ms, tp.ms(),
                  expect_fsm_equal("main fsm_act", (k[0],) + k[1],
                                   (p[0],) + p[1]), tk.ms() / reps)
    log(f"[timing] fsm_act {BOARDS}: kernel {kernel_ms:.4f} ms (device; "
        f"{ACT_KERNEL_MS_BEFORE} ms one board per CTA), entry point "
        f"{tk.ms() / reps:.3f} ms (no PyTorch operator but allocations, "
        f"one launch of fsm_act_kernel), "
        f"plain {tp.ms():.3f} ms, kernel == plain")
    torch.cuda.synchronize()
    return out


def expect_env_equal(what: str, a, b) -> None:
    """Every EnvState field, the game's 16 fields and the reset key
    included, bit for bit (``b`` may live on another device)."""
    import torch

    from pomcpp_tpu_torch.convert import diff_fields

    bad = diff_fields(a.game, b.game, skip=())
    if bad:
        raise AssertionError(f"{what}: card and plain differ in game {bad}")
    for name in ("done", "winner", "is_draw", "key"):
        if not torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()):
            raise AssertionError(f"{what}: card and plain differ in {name}")


def env_held_start(b: int, seed: int, all_done: bool = False):
    """CPU EnvState with boards that win at once (one agent left), boards
    with one agent of each team left, one team left, nobody left, and
    boards already done (every board, with ``all_done``); the rest play
    on."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_reset

    es = env_reset(seed, b, device="cpu")
    dead = torch.zeros((b, 4), dtype=torch.bool)
    n = b // 16
    dead[:n, 1:] = True
    dead[n:2 * n, 2:] = True
    dead[2 * n:3 * n, 0] = dead[2 * n:3 * n, 2] = True
    dead[3 * n:4 * n] = True
    done = torch.full((b,), all_done)
    done[4 * n:5 * n] = True
    return es._replace(game=kill(es.game, dead), done=done)


def phase_env_held(dev):
    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import _to_device
    from pomcpp_tpu_torch.env.environment import (
        env_step_auto_reset_batch,
        env_step_auto_reset_batch_fsm,
    )

    b, steps = ENV_HELD_BOARDS, ENV_HELD_STEPS
    gen = torch.Generator().manual_seed(41)
    moves = torch.randint(0, 6, (steps, b, 4), generator=gen, dtype=torch.int32)
    rands = torch.randint(0, 5, (steps, b, 4), generator=gen, dtype=torch.int32)

    def stats(es, seen):
        seen["resets"] += int(es.done.sum())
        return seen

    def note(es_before, es, seen):
        new = es.done & ~es_before.done
        seen["wins"] += int((new & ~es.is_draw).sum())
        seen["draws"] += int((new & es.is_draw).sum())

    for what, kw, inject, all_done in (
        ("fused, injected fresh boards", dict(max_steps=24), True, False),
        ("fused, own Philox resets, randomize_positions",
         dict(max_steps=24, randomize_positions=True), False, False),
        ("fused, team mode, own resets", dict(max_steps=30, team_mode=True),
         False, False),
        ("fused, every board done at entry", dict(max_steps=24), False, True),
    ):
        card = plain = env_held_start(b, 3, all_done)
        seen = dict(resets=0, wins=0, draws=0)
        for t in range(steps):
            fresh = random_cell_state(b, generator=gen, randomize_positions=True) \
                if inject else None
            stats(plain, seen)
            nxt = env_step_auto_reset_batch(
                plain, moves[t], fused=True, fresh=fresh, device="cpu", **kw)
            note(plain, nxt, seen)
            plain = nxt
            card = env_step_auto_reset_batch(
                card, moves[t], fused=True,
                fresh=None if fresh is None else _to_device(fresh, dev),
                device=dev, **kw)
            expect_env_equal(f"env {what} t={t}", card, plain)
        assert min(seen.values()) > 0, f"env {what}: {seen}"
        log(f"[env] held: {what}: {b} x {steps}: card == plain ({seen})")

    for what, kw, use_rands, inject in (
        ("rand_moves", dict(max_steps=24), True, False),
        ("seed (Philox rands), team mode, randomize_positions",
         dict(max_steps=24, team_mode=True, randomize_positions=True), False,
         False),
        ("seed, injected fresh boards", dict(max_steps=24), False, True),
    ):
        card = plain = env_held_start(b, 4)
        fsm_c = fsm_p = simple_fsm_state_init(b, "cpu")
        init = simple_fsm_state_init(b, "cpu")
        seen = dict(resets=0, wins=0, draws=0)
        for t in range(steps):
            stats(plain, seen)
            was_done = plain.done[:, None]
            fresh = random_cell_state(b, generator=gen) if inject else None
            kw.update(rand_moves=rands[t] if use_rands else None)
            nxt, fsm_p = env_step_auto_reset_batch_fsm(
                plain, moves[t], fsm_p, (0,), 500 + t, device="cpu",
                fresh=fresh, **kw)
            note(plain, nxt, seen)
            plain = nxt
            card, fsm_c = env_step_auto_reset_batch_fsm(
                card, moves[t], fsm_c, (0,), 500 + t, device=dev,
                fresh=None if fresh is None else _to_device(fresh, dev), **kw)
            expect_env_equal(f"env fsm {what} t={t}", card, plain)
            expect_fsm_equal(f"env fsm {what} t={t}",
                             [a.cpu() for a in fsm_c], fsm_p)
            # The caller resets the FSM rows of boards that were done.
            fsm_p = type(fsm_p)(*(torch.where(was_done, i, a)
                                  for a, i in zip(fsm_p, init)))
            fsm_c = type(fsm_c)(*(torch.where(was_done.to(a.device),
                                              i.to(a.device), a)
                                  for a, i in zip(fsm_c, init)))
        assert min(seen.values()) > 0, f"env fsm {what}: {seen}"
        log(f"[env] held: mixed control, {what}: {b} x {steps}: "
            f"card == plain ({seen})")


class EnvCounts:
    """Wins, draws and resets of an env loop, summed on the device."""

    def __init__(self, dev):
        import torch

        self.t = torch.zeros(3, dtype=torch.int64, device=dev)

    def add(self, before, after):
        import torch

        new = after.done & ~before.done
        self.t += torch.stack([(new & ~after.is_draw).sum(),
                               (new & after.is_draw).sum(),
                               before.done.sum()])

    def read(self) -> dict:
        return dict(zip(("wins", "draws", "resets"), self.t.tolist()))


def check_env(es) -> None:
    check_invariants(es.game)
    assert (es.winner[~es.done] == -1).all(), "winner set on a running game"
    assert not (es.is_draw & ~es.done).any(), "draw flag on a running game"
    assert ((es.winner >= -1) & (es.winner < 4)).all()
    assert (es.key[:, 2] >= 1).all()


def fused_env_loop(es, gen, steps, counts=None, observe=False):
    """``steps`` fused env steps with moves from ``gen``; host-clock seconds
    with a device barrier at the end."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_step_auto_reset_batch
    from pomcpp_tpu_torch.env.observation import observe_ego

    b, dev = es.done.shape[0], es.done.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = None
    for _ in range(steps):
        mv = torch.randint(0, 6, (b, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        nxt = env_step_auto_reset_batch(es, mv, fused=True, max_steps=800)
        if counts is not None:
            counts.add(es, nxt)
        es = nxt
        if observe:
            obs = observe_ego(es.game)
    torch.cuda.synchronize()
    return es, time.perf_counter() - t0, obs


def mixed_env_loop(es, fsm, gen, steps, seed, counts=None):
    """``steps`` mixed-control env steps (learner slot 0 random, three
    in-kernel SimpleAgents), the FSM rows of finished boards reset as a
    caller does; host-clock seconds with a device barrier at the end."""
    import torch

    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.env.environment import env_step_auto_reset_batch_fsm

    b, dev = es.done.shape[0], es.done.device
    init = simple_fsm_state_init(b, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        mv = torch.randint(0, 6, (b, 4), generator=gen, device=dev,
                           dtype=torch.int32)
        was_done = es.done[:, None]
        nxt, fsm = env_step_auto_reset_batch_fsm(es, mv, fsm, (0,), seed + t,
                                                 max_steps=800)
        fsm = type(fsm)(*(torch.where(was_done, i, a)
                          for a, i in zip(fsm, init)))
        if counts is not None:
            counts.add(es, nxt)
        es = nxt
    torch.cuda.synchronize()
    return es, fsm, time.perf_counter() - t0


def launches_per_call(before: dict, calls: int) -> dict:
    """The port's launches since ``before``, per call, by kernel."""
    from pomcpp_tpu_torch import _ext

    return {k: (v - before[k]) / calls for k, v in _ext.LAUNCHES.items()
            if v != before[k]}


def no_host_read(fn, calls: int = 3) -> None:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    call that waits for the device (a device-to-host read) raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(calls):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of ``fn``: the stream is held busy
    (``torch.cuda._sleep``) while the host queues ``reps`` calls between two
    events, so the host's own time per call stays out of the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)      # tens of ms at the card's clocks
    with Timer() as t:
        for _ in range(reps):
            fn()
    return t.ms() / reps


# Operators that only allocate or view: they launch nothing on the device.
NO_DEVICE_WORK = ("aten.empty", "aten.view", "aten.alias", "aten.detach",
                  "aten.as_strided", "aten.unbind")


def device_ops(fn) -> list:
    """The PyTorch operators that one call of ``fn`` dispatches, apart from
    those of ``NO_DEVICE_WORK``: a ``TorchDispatchMode`` sees every
    operator, so every kernel or copy that PyTorch launches shows here."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith(NO_DEVICE_WORK):
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


def env_max_abs_err(a, b) -> int:
    """Largest absolute difference over every EnvState field (``b`` may
    live on another device)."""
    games = max_abs_err(a.game, type(a.game)(*(t.to(a.done.device)
                                                for t in b.game)))
    rest = max(int((x.long() - y.to(x.device).long()).abs().max())
               for x, y in zip(a[1:], b[1:]))
    return max(games, rest)


def phase_env_main(dev):
    """The env layer's path at full width; returns rates, launch counts and
    the env kernels' times."""
    import numpy as np
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.env import environment as env
    from pomcpp_tpu_torch.env.gym_adapter import PommermanEnv

    gen = torch.Generator(device=dev).manual_seed(51)
    es = env.env_reset(7, BOARDS)
    es, _, _ = fused_env_loop(es, gen, 4)           # warm-up, not counted
    fsm = simple_fsm_state_init(BOARDS)
    es, fsm, _ = mixed_env_loop(es, fsm, gen, 4, 8000)
    res = {}

    _ext.reset_launches()
    counts = EnvCounts(dev)
    before = dict(_ext.LAUNCHES)
    es, sec, _ = fused_env_loop(es, gen, ENV_STEPS, counts)
    check_env(es)
    per_call = launches_per_call(before, ENV_STEPS)
    if per_call != {"fused_env_step_kernel": 1.0}:
        raise AssertionError(f"a fused env step launched {per_call}")
    res["fused"] = BOARDS * ENV_STEPS / sec
    res["fused_ms"] = sec / ENV_STEPS * 1e3
    log(f"[env] main: fused env step, {BOARDS} boards x {ENV_STEPS} steps: "
        f"{res['fused']:.0f} env-steps/s ({res['fused_ms']:.3f} ms per "
        f"step), {counts.read()}; launches per step {per_call}")

    counts = EnvCounts(dev)
    before = dict(_ext.LAUNCHES)
    es, fsm, sec = mixed_env_loop(es, fsm, gen, ENV_STEPS, 9000, counts)
    check_env(es)
    assert ((fsm.rp_count >= 0) & (fsm.rp_count <= 4)).all(), "ring count"
    per_call = launches_per_call(before, ENV_STEPS)
    if per_call != {"rollout_chunk_simple_kernel": 1.0,
                    "env_merge_kernel": 1.0}:
        raise AssertionError(f"a mixed-control env step launched {per_call}")
    res["fsm"] = BOARDS * ENV_STEPS / sec
    res["fsm_ms"] = sec / ENV_STEPS * 1e3
    log(f"[env] main: mixed-control env step (learner slot 0 random, three "
        f"in-kernel SimpleAgents), {BOARDS} boards x {ENV_STEPS} steps: "
        f"{res['fsm']:.0f} env-steps/s ({res['fsm_ms']:.3f} ms per step), "
        f"{counts.read()}; launches per step {per_call}")

    # Neither env step reads anything back from the device.
    mv = torch.randint(0, 6, (BOARDS, 4), generator=gen, device=dev,
                       dtype=torch.int32)
    no_host_read(lambda: env.env_step_auto_reset_batch(
        es, mv, fused=True, max_steps=800, team_mode=True,
        randomize_positions=True))
    no_host_read(lambda: env.env_step_auto_reset_batch_fsm(
        es, mv, fsm, (0,), 7, max_steps=800))
    log("[env] main: both env steps ran under "
        "torch.cuda.set_sync_debug_mode('error'): no device-to-host read")

    es, sec, obs = fused_env_loop(es, gen, ENV_OBS_STEPS, observe=True)
    w = 9
    assert obs.board.shape == (BOARDS, 4, w * w) and obs.board.dtype == torch.int32
    centre = obs.board[:, :, (w * w) // 2]
    ids = torch.arange(4, device=dev) + 10
    assert ((centre == ids) | es.game.agent_dead).all(), "ego crop off centre"
    assert ((obs.board >= 0) & (obs.board <= 13)).all()
    res["observe"] = BOARDS * ENV_OBS_STEPS / sec
    log(f"[env] main: fused env step + observe_ego for four agents, {BOARDS} "
        f"boards x {ENV_OBS_STEPS} steps: {res['observe']:.0f} env-steps/s")

    gym = PommermanEnv(batch_size=GYM_BOARDS, fog="ego", max_episode_steps=800)
    obs, info = gym.reset(seed=3)
    rng = np.random.RandomState(5)
    total = np.zeros((GYM_BOARDS, 4), np.float32)
    ended = 0
    t0 = time.perf_counter()
    for _ in range(GYM_STEPS):
        obs, reward, term, trunc, info = gym.step(
            rng.randint(0, 6, size=(GYM_BOARDS, 4)))
        total += reward
        ended += int(term.sum() + trunc.sum())
    sec = time.perf_counter() - t0
    assert len(obs) == 4 and obs[0]["board"].shape == (GYM_BOARDS, 9, 9)
    assert np.isin(reward, (-1.0, 0.0, 1.0)).all() and np.isfinite(total).all()
    assert info["alive"].shape == (GYM_BOARDS, 4)
    check_env(gym._es)
    res["gym"] = GYM_BOARDS * GYM_STEPS / sec
    log(f"[env] main: PommermanEnv(batch_size={GYM_BOARDS}, fog='ego') x "
        f"{GYM_STEPS} steps through numpy: {res['gym']:.0f} env-steps/s, "
        f"{ended} episodes ended, {int((total < 0).sum())} agents died")
    res["launches"] = dict(_ext.LAUNCHES)
    log(f"[env] launches: {res['launches']}")
    expect_launched(res["launches"], ENV_KERNELS, "the env path")
    res["state"], res["fsm_state"] = es, fsm
    return res


def phase_env_timing(es):
    """The env kernels at full width, each against its plain version on the
    same inputs (bit for bit) and timed: device ms of one launch, and ms of
    the plain version on the card."""
    import torch

    from pomcpp_tpu_torch import launch
    from pomcpp_tpu_torch.device import HBM_BYTES_PER_S
    from pomcpp_tpu_torch.engine.fused_step import fused_step_plain
    from pomcpp_tpu_torch.env import environment as env

    gen = torch.Generator(device=es.done.device).manual_seed(71)
    mv = torch.randint(0, 6, (BOARDS, 4), generator=gen,
                       device=es.done.device, dtype=torch.int32)
    kw = dict(team_mode=False, max_steps=800, randomize_positions=False)
    out = {}
    card = env.env_step_auto_reset_batch(es, mv, fused=True, **kw)
    with Timer() as tp:
        game = fused_step_plain(es.game, mv)
        game = game._replace(timestep=game.timestep + 1)
        plain = env._merge_done_and_reset(es, game, fresh=None, **kw)
    expect_env_equal("env step at full width", card, plain)
    out["env_step"] = (device_ms(lambda: env.env_step_auto_reset_batch(
        es, mv, fused=True, **kw)), tp.ms(), env_max_abs_err(card, plain))
    # The merge writes its stepped game in place: it gets a copy, which every
    # timed call writes again with the same fresh games.
    mine = type(game)(*(t.clone() for t in game))

    def merge():
        merged, rest = launch.env_merge(*launch.card(es.done.device), es[1:],
                                        mine, None, **kw)
        return env.EnvState(merged, *rest)

    card = merge()
    with Timer() as tp:
        plain = env._merge_done_and_reset(es, game, fresh=None, **kw)
    expect_env_equal("env merge at full width", card, plain)
    out["env_merge"] = (device_ms(merge), tp.ms(),
                        env_max_abs_err(card, plain))
    done = int(es.done.sum())
    for name, (ms, plain_ms, _) in out.items():
        log(f"[timing] {name} {BOARDS} boards ({done} done): "
            f"kernel {ms:.4f} ms (device), plain {plain_ms:.3f} ms, "
            f"kernel == plain")
    # The bytes the merge needs on this run's done boards, read and written:
    # its rate beside the memory's, and beside one device-to-device copy_
    # that reads and writes as many bytes, a reference that no path calls.
    moved = (BOARDS - done) * MERGE_RUNNING_BYTES + done * MERGE_DONE_BYTES
    src = torch.empty(moved // 2, dtype=torch.uint8, device=es.done.device)
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src))
    merge_ms = out["env_merge"][0]
    out["merge_rate"] = dict(done_boards=done, bytes=moved,
                             bytes_per_s=moved / merge_ms * 1e3,
                             copy_ms=copy_ms,
                             copy_bytes_per_s=2 * src.numel() / copy_ms * 1e3)
    log(f"[timing] env_merge {BOARDS} boards ({done} done): {merge_ms:.4f} ms "
        f"(device; {MERGE_KERNEL_MS_BEFORE} ms on the lane layout, every "
        f"board copied), {moved} bytes read and written, "
        f"{out['merge_rate']['bytes_per_s'] / 1e12:.3f} TB/s of "
        f"{HBM_BYTES_PER_S / 1e12:.2f}; copy_ of {src.numel()} bytes "
        f"{copy_ms:.4f} ms, {out['merge_rate']['copy_bytes_per_s'] / 1e12:.3f} "
        f"TB/s")
    return out


def profile_env(es, fsm) -> None:
    """Kernels and copies per env step, device time by kernel and the
    device's idle share over 32 fused and 32 mixed-control env steps
    (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=es.done.device).manual_seed(61)
    for what, loop in (
        ("fused", lambda e: fused_env_loop(e, gen, 32)[1]),
        ("mixed-control", lambda e: mixed_env_loop(e, fsm, gen, 32, 600)[2]),
    ):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sec = loop(es)
        # Kernels and device copies only: an operator's event repeats the
        # time of the kernels it launched.
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise RuntimeError(f"torch.profiler recorded no device activity "
                               f"over 32 {what} env steps")
        total = sum(e.device_time_total for e in events)
        launches = sum(e.count for e in events)
        log(f"[profile] 32 {what} env steps: {sec / 32 * 1e3:.3f} ms per step "
            f"on the host clock (profiler on), {total / 32e3:.3f} ms of device "
            f"time per step in {launches / 32:.2f} kernels and copies: device "
            f"idle {1 - total / 1e6 / sec:.3f} of the time")
        for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
            log(f"[profile] {e.device_time_total / 32:9.1f} us/step  "
                f"x{e.count / 32:6.2f}/step  {e.key[:100]}")


def phase_shares(rows) -> dict:
    """From sampled calls' phase totals (``trace.PhaseRow``): each phase's
    share of the summed warp cycles, the warp cycles and the event counts
    per step."""
    from pomcpp_tpu_torch.trace import PHASES

    got = {k: sum(r.totals[k] for r in rows) for k in PHASES}
    cycles = sum(v for k, v in got.items() if not k.startswith("n_"))
    steps = max(got["n_steps"], 1)
    out = {k: round(v / max(cycles, 1), 4) for k, v in got.items()
           if not k.startswith("n_")}
    out["warp_cycles_per_step"] = round(cycles / steps, 1)
    for k in ("n_bfs_rounds", "n_bfs_acts", "n_bomb_steps", "n_move_passes",
              "n_blasts"):
        out[k + "_per_step"] = round(got[k] / steps, 4)
    return out


PROFILE_CHUNKS = 16


def profile_chunk_phases(smi: str) -> None:
    """Where a chunk's warp cycles go (``--profile``): ``PROFILE_CHUNKS``
    chunks of each policy at the main path's size with the port's tracing
    on, so that every ``trace.SAMPLE_EVERY``-th launches the clocked
    instance, held to the same chunks with tracing off.  The clocks cost
    registers and time: the sampled calls' device times are printed beside
    the others'."""
    from pomcpp_tpu_torch import _ext, trace
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine import fused_step as fs
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init

    res = kernel_resources(_ext.build_log(("kernels",)))
    cs0 = random_cell_state(BOARDS, seed=0)
    for policy in ("harmless", "random", "simple"):
        start = (cs0, simple_fsm_state_init(BOARDS)
                 if policy == "simple" else None)
        ends, ms = [], {True: [], False: []}
        trace.clear()
        for traced in (True, False):
            if traced:
                trace.enable()
            state = start
            for chunk in range(PROFILE_CHUNKS):
                with Timer() as tm:
                    out = fs.rollout_chunk(state[0], 100 + chunk, CHUNK, policy,
                                           fsm_state=state[1])
                sampled = traced and (chunk + 1) % trace.SAMPLE_EVERY == 0
                ms[sampled].append(tm.ms())
                state = out if policy == "simple" else (out, None)
            trace.disable()
            ends.append(state)
        rows = trace.phase_rows()
        if len(rows) != PROFILE_CHUNKS // trace.SAMPLE_EVERY:
            raise AssertionError(f"{policy}: {len(rows)} sampled calls")
        expect_equal(f"phase clocks, {policy}", ends[0][0], ends[1][0])
        if policy == "simple":
            expect_fsm_equal("phase clocks, FSM", ends[0][1], ends[1][1])
        name = ("rollout_chunk_clocked_simple_kernel" if policy == "simple"
                else "rollout_chunk_clocked_kernel")
        log(f"[profile] {policy} chunk with phase clocks: "
            f"{json.dumps(phase_shares(rows))}; sampled chunk ms "
            f"{[round(t, 3) for t in ms[True]]}, the others' median "
            f"{statistics.median(ms[False]):.3f}, {json.dumps(res.get(name, {}))}, "
            f"== tracing off, on {smi}")


def probe_outputs_equal(what: str, a, b) -> int:
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    worst = 0
    for k, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            n = int((x != y).sum())
            raise AssertionError(f"{what}: kernel and plain differ in output "
                                 f"{k} ({n} of {x.numel()} values)")
        worst = max(worst, int((x.double() - y.double()).abs().max()))
    return worst


def phase_probes_held(dev):
    """Every pattern, both layouts, against its plain version on seeded
    inputs at a small loop count: every row live, and but for the tile
    reductions the first 32 rows of each 128 live, and 130 rows."""
    from pomcpp_tpu_torch import probes

    n = 0
    for i, p in enumerate(probes.PATTERNS):
        cases = [(PROBE_HELD_ROWS, 128)]
        if p.op not in probes.TILE_OPS:
            cases.append((PROBE_HELD_ROWS, 32))
            cases.append((130, 128))       # ragged last warps and CTAs
        for rows_total, rows in cases:
            inputs = probes.pattern_inputs(p, rows_total, dev, seed=100 + i)
            want = probes.run_pattern(p, inputs, k=PROBE_HELD_K, plain=True,
                                      rows=rows)
            for layout in probes.LAYOUTS:
                got = probes.run_pattern(p, inputs, k=PROBE_HELD_K,
                                         layout=layout, rows=rows)
                probe_outputs_equal(
                    f"probe {probes.label(p)} {layout} rows={rows} of "
                    f"{rows_total}", got, want)
                n += 1
    log(f"[probes] held: {len(probes.PATTERNS)} patterns x 2 layouts, {n} "
        f"comparisons at K={PROBE_HELD_K}: kernel == plain")
    err = probe_dot_random(dev)
    log(f"[probes] held: dot on random floats, K=1 (32 products): kernel "
        f"within {err:.3g} of the plain f32 chain (tolerance "
        f"{DOT_RANDOM_TOL})")


# ``dot`` on random floats, x in [-1, 1) and W in [-1/32, 1/32): each
# product is within 2^-15 of |x| @ |W| (<= 2^-14 here) of the exact one in
# both chains (TF32 pieces; plain f32), and W contracts (spectral radius
# about 0.2), so the two chains stay within 1e-4 of each other.
DOT_RANDOM_TOL = 1e-4


def probe_dot_random(dev) -> float:
    import torch

    from pomcpp_tpu_torch import probes

    gen = torch.Generator().manual_seed(81)
    x = (torch.rand((PROBE_HELD_ROWS, 128), generator=gen) * 2 - 1).to(dev)
    w = ((torch.rand((128, 128), generator=gen) * 2 - 1) / 32).to(dev)
    got = probes.probe_dot(x, w, "dot", 1, device=dev)
    want = probes.probe_dot_plain(x, w, "dot", 1)
    err = float((got - want).abs().max())
    if not err <= DOT_RANDOM_TOL:
        raise AssertionError(f"dot on random floats: error {err}")
    return err


def phase_probes_main(dev):
    """The probes' own path (``probes.run_report``) and, at the same sizes,
    every pattern's plain version; returns per-pattern rows and launches."""
    import torch

    from pomcpp_tpu_torch import _ext, probes
    from pomcpp_tpu_torch.device import card_rates, time_device

    _ext.reset_launches()
    report = probes.run_report(n_rows=PROBE_ROWS,
                               out=lambda line: log(f"[probes] {line}"))
    launches = dict(_ext.LAUNCHES)
    log(f"[probes] launches: {launches}")
    expect_launched(launches, PROBE_KERNELS, "the probes' path")

    ms = {(probes.label(p), layout): t for p, layout, t in report}
    rates = card_rates()
    rows = []
    for p in probes.PATTERNS:
        inputs = probes.pattern_inputs(p, PROBE_ROWS, dev)
        with Timer() as tp:
            want = probes.run_pattern(p, inputs, plain=True)
        err = 0
        for layout in probes.LAYOUTS:
            got = probes.run_pattern(p, inputs, layout=layout)
            err = max(err, probe_outputs_equal(
                f"probe {probes.label(p)} {layout} at K={p.k}", got, want))
        bound, term = probes.bound(p, PROBE_ROWS, rates)
        simt_ms = library = None
        if p.op == "dot":
            # The f32 SIMT chain it replaced, and one torch.matmul a product.
            simt_ms = probes.work(p, PROBE_ROWS)[0] / rates.issue * 1e3
            x, w = inputs["x"], inputs["w"]
            torch.matmul(x, w)
            with Timer() as tl:
                for _ in range(p.k * 32):
                    x = torch.matmul(x, w)
            library = tl.ms()
        elif p.closed:      # one PyTorch call computes the closed form
            x, form = inputs["x"], probes.CLOSED_FORMS[p.op]
            probe_outputs_equal(f"closed form of {probes.label(p)}",
                                form(x, p.k), want)
            library = time_device(lambda: form(x, p.k), dev)
        rows.append({
            "pattern": probes.label(p),
            "kernel": probes.kernel_of(p),
            "cta_ms": ms[probes.label(p), "cta"],
            "warp_ms": ms[probes.label(p), "warp"],
            "plain_ms": tp.ms(), "max_abs_err": err,
            "bound_ms": bound, "bound_by": term,
            "library_ms": library,
            **({"simt_bound_ms": simt_ms} if simt_ms else {}),
        })
        log(f"[probes] {probes.label(p):28s} cta {rows[-1]['cta_ms']:9.4f} ms, "
            f"warp {rows[-1]['warp_ms']:9.4f} ms, plain {tp.ms():9.3f} ms, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})"
            + (f", torch.matmul chain {library:.3f} ms, f32 SIMT bound "
               f"{simt_ms:.2f} ms" if simt_ms else "")
            + (f", its closed form in one PyTorch call {library:.4f} ms"
               if p.closed else "")
            + f": kernel == plain at K={p.k}")
    torch.cuda.synchronize()
    # A bound is the least time the card could take: a pattern faster than
    # its bound has a count that is wrong, and is recounted, never clamped.
    over = [f"{r['pattern']} {min(r['cta_ms'], r['warp_ms']):.4f} ms < "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            for r in rows if min(r["cta_ms"], r["warp_ms"]) < r["bound_ms"]]
    if over:
        raise AssertionError("probe rows above 100% of their bound: "
                             + "; ".join(over))
    log("[probes] every pattern at or below 100% of its bound")
    return rows, launches


# --- Phase 9: the learner ---------------------------------------------------

LEARN_BATCH, LEARN_ROLLOUT, LEARN_TIMED = 2048, 64, 3   # docs/TRAINING.md:33
SELFPLAY_BATCH, SELFPLAY_TIMED = 4096, 2
# The held comparisons run at the full-width runs' own board counts, for
# fewer steps: the step cap falls inside them (``learn_held_start``).
LEARN_HELD_BOARDS = {"simple": LEARN_BATCH, "selfplay": SELFPLAY_BATCH}
LEARN_HELD_STEPS, LEARN_HELD_CAP = 8, 12
# The held update's minibatches: 4 x 32,768 rows, self-play's minibatch.
LEARN_HELD_MINIBATCHES = 4
WIN_BOARDS, WIN_STEPS = 1024, 832
# Card (cuDNN / cuBLAS bf16) against the same call on the CPU: logp and value
# of the collector (max abs), and, after one update from the same params and
# batch, the loss (relative) and each parameter leaf's change (relative L2).
# Set at about 4x what an NVIDIA H100 80GB HBM3 gave at 256 boards x 16 steps
# and an update of two 8,192-row minibatches (2.4e-4, 3.5e-4, 7.1e-5, 0.0100);
# at the held sizes above it gives 4.5e-4, 4.7e-4, 5.2e-5, 0.0136.
LEARN_TOL = {"logp": 1e-3, "value": 1.5e-3, "loss": 3e-4, "update": 0.04}
LEARN_CKPT = "artifacts/ppo_vs_simple"


def flagship_cfg():
    """The recipe of docs/TRAINING.md:33-35 (``--batch 2048 --rollout 64
    --epochs 1 --opponent simple --learner-slots 0 --fused``)."""
    from pomcpp_tpu_torch.learner.ppo import PPOConfig

    return PPOConfig(rollout_len=LEARN_ROLLOUT, epochs=1, minibatches=2,
                     opponent="simple", learner_slots=(0,), fused_env=True,
                     max_episode_steps=800)


def selfplay_cfg():
    from pomcpp_tpu_torch.learner.ppo import PPOConfig
    from pomcpp_tpu_torch.train_ppo import auto_minibatches

    return PPOConfig(rollout_len=LEARN_ROLLOUT, epochs=2, fused_env=True,
                     minibatches=auto_minibatches(SELFPLAY_BATCH,
                                                  LEARN_ROLLOUT, 4))


def learn_held_start(b: int, seed: int):
    """CPU boards stepped 12 random fused env steps (bombs in play), with
    timesteps spread over 0..11, so that ``LEARN_HELD_CAP`` falls inside
    the held runs' steps for most boards, and the scenarios of
    ``env_held_start`` in the first boards."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_step_auto_reset_batch

    es = env_held_start(b, seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(12):
        mv = torch.randint(0, 6, (b, 4), generator=gen, dtype=torch.int32)
        es = env_step_auto_reset_batch(es, mv, fused=True, device="cpu")
    ts = torch.randint(0, 12, (b,), generator=gen, dtype=torch.int32)
    return es._replace(game=es.game._replace(timestep=ts))


def held_collect(model, es, cfg, dev, hooks):
    """``collect_rollout_batch`` on ``dev`` with the hooks moved there and,
    against SimpleAgents, a fresh FSM state."""
    import torch

    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import _to_device
    from pomcpp_tpu_torch.env.environment import _env_to_device
    from pomcpp_tpu_torch.learner.ppo import collect_rollout_batch

    kw = {"moves": hooks["moves"].to(dev),
          "fresh": [_to_device(c, dev) for c in hooks["fresh"]]}
    if cfg.opponent:
        kw["rand_moves"] = hooks["rand_moves"].to(dev)
        kw["opp_state"] = simple_fsm_state_init(es.done.shape[0], dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return collect_rollout_batch(model, _env_to_device(es, dev), cfg, gen,
                                 device=dev, **kw)


def rel_l2(a, b) -> float:
    """Relative L2 difference of ``b`` from ``a`` (any devices)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


def phase_learn_held(dev, boards=None):
    """The collector and one update on the card against the same calls on
    CPU tensors, at ``boards`` (default ``LEARN_HELD_BOARDS``: the
    full-width runs' board counts); returns the measured differences."""
    import copy

    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.learner.ppo import (
        PPOConfig,
        compute_gae,
        flatten_batch,
        ppo_init,
        ppo_update,
    )

    boards = boards or LEARN_HELD_BOARDS
    steps = LEARN_HELD_STEPS
    gen = torch.Generator().manual_seed(71)
    err = {"logp": 0.0, "value": 0.0}
    batches = {}
    for name, kernels, extra in (
        ("simple", {"rollout_chunk_simple_kernel": steps,
                    "env_merge_kernel": steps,
                    "ego_features_kernel": steps + 1},
         dict(opponent="simple", learner_slots=(0,))),
        ("selfplay", {"fused_env_step_kernel": steps,
                      "ego_features_kernel": steps + 1}, {}),
    ):
        b = boards[name]
        cfg = PPOConfig(rollout_len=steps, fused_env=True,
                        max_episode_steps=LEARN_HELD_CAP, **extra)
        n = len(cfg.learner_slots) if cfg.opponent else 4
        hooks = {
            "moves": torch.randint(0, 6, (steps, b, n), generator=gen,
                                   dtype=torch.int32),
            "fresh": [random_cell_state(b, generator=gen, device="cpu")
                      for _ in range(steps)],
        }
        if cfg.opponent:
            hooks["rand_moves"] = torch.randint(0, 5, (steps, b, 4),
                                                generator=gen,
                                                dtype=torch.int32)
        es = learn_held_start(b, 72)
        model = ppo_init(3, cfg, "cpu").model
        plain = held_collect(model, es, cfg, torch.device("cpu"), hooks)
        _ext.reset_launches()
        card = held_collect(copy.deepcopy(model).to(dev), es, cfg, dev, hooks)
        got = {k: v for k, v in _ext.LAUNCHES.items() if v}
        if dev.type == "cuda" and got != kernels:
            raise AssertionError(f"[learn] held {name}: launches {got}, "
                                 f"expected {kernels}")
        expect_env_equal(f"[learn] held {name} final env", card[0], plain[0])
        if cfg.opponent:
            expect_fsm_equal(f"[learn] held {name} FSM",
                             [t.cpu() for t in card[3]], plain[3])
        tc, tp = card[1], plain[1]
        for field in tp._fields:
            a, c = getattr(tp, field), getattr(tc, field).cpu()
            if field in err:
                e = float((a - c).abs().max())
                err[field] = max(err[field], e)
                if e > LEARN_TOL[field]:
                    raise AssertionError(f"[learn] held {name}: {field} "
                                         f"differs by {e}")
            elif not torch.equal(a, c):
                raise AssertionError(f"[learn] held {name}: {field} differs")
        e = float((card[2].cpu() - plain[2]).abs().max())
        err["value"] = max(err["value"], e)
        if e > LEARN_TOL["value"]:
            raise AssertionError(f"[learn] held {name}: boot value by {e}")
        seen = {"resets": int((~tp.valid).sum()), "ends": int(tp.done.sum()),
                "draws": int(tp.draw.sum()),
                "deaths": int((tp.reward < 0).sum()),
                "wins": int((tp.reward > 0).sum())}
        if min(seen["resets"], seen["draws"], seen["deaths"]) == 0:
            raise AssertionError(f"[learn] held {name}: window too quiet "
                                 f"{seen}")
        log(f"[learn] held {name}, {b} boards x {steps} steps, card == CPU "
            f"bit for bit (env, FSM, feats, moves, rewards, masks), launches "
            f"{got}, {seen}")
        batches[name] = (cfg, model, tp, plain[2])

    # One update from the same params and batch, contiguous minibatches.
    cfg, model, traj, boot = batches["selfplay"]
    cfg = cfg._replace(epochs=1, minibatches=LEARN_HELD_MINIBATCHES,
                       shuffle_minibatches=False)
    adv, ret = compute_gae(traj, boot, cfg)
    flat = flatten_batch(traj, adv, ret)
    results = []
    for d in (torch.device("cpu"), dev):
        ts = ppo_init(3, cfg, d)
        ts.model.load_state_dict(model.state_dict())
        before = [p.detach().clone() for p in ts.model.parameters()]
        ts, metrics = ppo_update(ts, tuple(x.to(d) for x in flat), cfg)
        delta = [p.detach() - q for p, q in zip(ts.model.parameters(), before)]
        results.append((float(metrics["loss"]), delta))
    (loss_cpu, d_cpu), (loss_card, d_card) = results
    err["loss"] = abs(loss_card - loss_cpu) / abs(loss_cpu)
    err["update"] = max(rel_l2(a, b) for a, b in zip(d_cpu, d_card))
    for k in ("loss", "update"):
        if err[k] > LEARN_TOL[k]:
            raise AssertionError(f"[learn] held update: {k} differs by "
                                 f"{err[k]}")
    log(f"[learn] held: card vs CPU, logp {err['logp']:.3g} (tolerance "
        f"{LEARN_TOL['logp']}), value {err['value']:.3g} "
        f"({LEARN_TOL['value']}); one update ({len(flat[0])} rows, "
        f"{cfg.minibatches} minibatches): loss {loss_card:.6g} vs "
        f"{loss_cpu:.6g}, relative {err['loss']:.3g} ({LEARN_TOL['loss']}); "
        f"parameter change, worst leaf's relative L2 {err['update']:.3g} "
        f"({LEARN_TOL['update']})")
    return err


def timed_iterations(ts, es, cfg, opp, iters, expect):
    """``iters`` ``ppo_train_step`` calls, each timed on the host clock with
    the host fetch of its metrics inside the window, and each holding the
    port's launches to ``expect``."""
    import math

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.learner.ppo import ppo_train_step

    rows = []
    for _ in range(iters):
        before = dict(_ext.LAUNCHES)
        t0 = time.perf_counter()
        if cfg.opponent:
            ts, es, metrics, opp = ppo_train_step(ts, es, cfg, opp)
        else:
            ts, es, metrics = ppo_train_step(ts, es, cfg)
        m = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in _ext.LAUNCHES.items()
               if v != before[k]}
        if got != expect:
            raise AssertionError(f"[learn] an iteration launched {got}, "
                                 f"expected {expect}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[learn] metrics not finite: {m}")
        rows.append((sec, m))
    return ts, es, opp, rows


def split_iteration(ts, es, cfg, opp):
    """One more iteration with CUDA events at its boundaries: ms of collect,
    GAE plus flatten, and update."""
    from pomcpp_tpu_torch.learner.ppo import (
        collect_rollout_batch,
        compute_gae,
        flatten_batch,
        ppo_update,
    )
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    out = collect_rollout_batch(ts.model, es, cfg, ts.gen, opp,
                                host_gen=ts.host_gen)
    ev[1].record()
    adv, ret = compute_gae(out[1], out[2], cfg)
    flat = flatten_batch(out[1], adv, ret)
    ev[2].record()
    ts, _ = ppo_update(ts, flat, cfg)
    ev[3].record()
    ev[3].synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    return ts, out[0], out[3] if cfg.opponent else None, dict(
        zip(("collect_ms", "gae_flatten_ms", "update_ms"), ms))


def rollout_step_profile(ts, es, cfg, opp, steps=4):
    """Kernels and copies per rollout step and the device's idle share over a
    ``steps``-step collect: device time from ``torch.profiler``, the step's
    wall time from a second run without it.  Raises where the profiler
    recorded no device activity, as ``profile_env`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pomcpp_tpu_torch.learner.ppo import collect_rollout_batch

    cfg = cfg._replace(rollout_len=steps)

    def run():
        collect_rollout_batch(ts.model, es, cfg, ts.gen, opp,
                              host_gen=ts.host_gen)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("[learn] torch.profiler recorded no device "
                           "activity over the rollout steps")
    device = sum(e.device_time_total for e in events) / steps / 1e6
    return {"wall_ms_per_step": wall * 1e3,
            "device_ms_per_step": device * 1e3,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "idle_share": 1 - device / wall}


def update_flop_per_row(model) -> int:
    """Operations of one row's forward and backward pass: two per
    multiply-add of every conv (at each of its output positions) and dense
    layer, forward; twice that backward (input and weight gradients), less
    the first layer's input gradient, which nothing needs."""
    positions = model.width * model.width
    macs = [layer.weight.numel() * (positions if layer.weight.dim() == 4
                                    else 1)
            for layer in (*model.convs, model.dense, model.policy,
                          model.value)]
    return 2 * sum(macs) + 4 * sum(macs) - 2 * macs[0]


def learn_run(name, cfg, batch, timed, expect, seed):
    """A training run at full width: 1 warm-up iteration, ``timed`` timed
    ones, one split into its parts by CUDA events, the rollout step's
    profile and the peak memory the run adds to what was allocated before
    it."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner.ppo import opponent_state_init, ppo_init

    # The peak is read above what earlier phases still hold, which a
    # reset of the peak counts in.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    ts = ppo_init(seed, cfg)
    es = env_reset(seed + 1, batch)
    opp = opponent_state_init(batch, cfg) if cfg.opponent else None
    ts, es, opp, _ = timed_iterations(ts, es, cfg, opp, 1, expect)
    ts, es, opp, rows = timed_iterations(ts, es, cfg, opp, timed, expect)
    ts, es, opp, split = split_iteration(ts, es, cfg, opp)
    prof = rollout_step_profile(ts, es, cfg, opp)
    slots = len(cfg.learner_slots) if cfg.opponent else 4
    flop = update_flop_per_row(ts.model) * batch * cfg.rollout_len * slots \
        * cfg.epochs
    res = {
        "boards": batch, "rollout": cfg.rollout_len, "epochs": cfg.epochs,
        "minibatches": cfg.minibatches,
        "env_steps_per_s": [batch * cfg.rollout_len / s for s, _ in rows],
        "iter_s": [s for s, _ in rows],
        **split,
        "update_flop": flop,
        "update_bound_ms": flop / BF16_OPS_PER_S * 1e3,
        "update_tflop_per_s": flop / split["update_ms"] / 1e9,
        "launches_per_iter": expect,
        "launches_per_rollout_step": {k: v / cfg.rollout_len
                                      for k, v in expect.items()},
        "rollout_step": prof,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - held_before,
        "held_before_bytes": held_before,
        "episodes": [m["episodes"] for _, m in rows],
        "metrics_last": rows[-1][1],
    }
    if sum(res["episodes"]) <= 0:
        raise AssertionError(f"[learn] {name}: no episode ended")
    log(f"[learn] {name}: {json.dumps(res)}")
    return res


def win_share(model, seed: int) -> dict:
    """The net in slot 0 against three in-kernel SimpleAgents, no update:
    ``WIN_BOARDS`` boards x ``WIN_STEPS`` steps; the share of finished games
    the net won."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner.ppo import (
        collect_rollout_batch,
        opponent_state_init,
    )

    cfg = flagship_cfg()
    es = env_reset(seed, WIN_BOARDS)
    opp = opponent_state_init(WIN_BOARDS, cfg)
    gen = torch.Generator(device=es.done.device).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    games = wins = draws = torch.zeros((), dtype=torch.int64,
                                       device=es.done.device)
    for _ in range(WIN_STEPS // cfg.rollout_len):
        es, traj, _, opp = collect_rollout_batch(model, es, cfg, gen, opp,
                                                 host_gen=host)
        games = games + traj.done.sum()
        draws = draws + traj.draw.sum()
        wins = wins + (traj.reward > 0).sum()
    games, wins, draws = int(games), int(wins), int(draws)
    return {"games": games, "wins": wins, "draws": draws,
            "share": wins / max(games, 1)}


def phase_learn_main(dev):
    """The learner at full width: the flagship recipe, shared-policy
    self-play, the no-host-read check and the checked-in weights' game."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner.ppo import (
        collect_rollout_batch,
        opponent_state_init,
        ppo_init,
    )
    from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

    # No host read inside a rollout, in either configuration.
    for cfg in (flagship_cfg(), selfplay_cfg()):
        cfg = cfg._replace(rollout_len=4)
        ts = ppo_init(5, cfg)
        es = env_reset(6, 256)
        opp = opponent_state_init(256, cfg) if cfg.opponent else None
        no_host_read(lambda: collect_rollout_batch(
            ts.model, es, cfg, ts.gen, opp, host_gen=ts.host_gen), calls=2)
    log("[learn] collect_rollout_batch, self-play and against SimpleAgents: "
        "no host read (set_sync_debug_mode('error'))")

    _ext.reset_launches()
    flagship = learn_run(
        "flagship (--batch 2048 --rollout 64 --epochs 1 --opponent simple "
        "--learner-slots 0 --fused)", flagship_cfg(), LEARN_BATCH,
        LEARN_TIMED, {"rollout_chunk_simple_kernel": LEARN_ROLLOUT,
                      "env_merge_kernel": LEARN_ROLLOUT,
                      "ego_features_kernel": LEARN_ROLLOUT + 1}, 11)
    selfplay = learn_run(
        "shared-policy self-play (--batch 4096 --rollout 64 --epochs 2 "
        "--fused)", selfplay_cfg(), SELFPLAY_BATCH, SELFPLAY_TIMED,
        {"fused_env_step_kernel": LEARN_ROLLOUT,
         "ego_features_kernel": LEARN_ROLLOUT + 1}, 13)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)

    # The checked-in weights play the same game.
    cfg = flagship_cfg()
    trained = restore_checkpoint(LEARN_CKPT, ppo_init(0, cfg)).model
    fresh = ppo_init(0, cfg).model
    t0 = time.perf_counter()
    wins = {"checkpoint": win_share(trained, 21),
            "fresh": win_share(fresh, 21)}
    log(f"[learn] {LEARN_CKPT} in slot 0 vs three in-kernel SimpleAgents, "
        f"{WIN_BOARDS} boards x {WIN_STEPS} steps, no update (the net's "
        f"training seat only): {json.dumps(wins)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not wins["checkpoint"]["share"] > wins["fresh"]["share"]:
        raise AssertionError(f"[learn] the checkpoint does not beat a fresh "
                             f"net: {wins}")
    return {"flagship": flagship, "selfplay": selfplay, "wins": wins,
            "launches": launches}


def phase_learn(dev):
    t0 = time.perf_counter()
    held = phase_learn_held(dev)
    res = phase_learn_main(dev)
    res["held"] = held
    log(f"[learn] phase took {time.perf_counter() - t0:.1f} s")
    return res


# --- Phase 10: search, distillation and the arena ----------------------------

AZ_BATCH = 1024                      # scripts/train_az.py's defaults
# The held searches.  What launches a kernel runs at the full-width runs'
# 1024 boards and train_az.py's depths (12, tree depth 6) with fewer
# simulations (their count only repeats the launches): the chunk search,
# the collector (two env steps, a step cap inside the window) and its
# update, and the arena's line-up (fewer steps, from mid-game boards).  The
# plane engine's planners launch no kernel of the port and stay at 256
# boards, whose CPU side sets their time.
SEARCH_HELD_BOARDS = {"kernel": AZ_BATCH, "plane": 256}
HELD_CHUNK = {"n_sim": 6, "depth": 12, "max_tree_depth": 6}
HELD_PLANE = {"n_sim": 6, "depth": 6, "max_tree_depth": 4}
HELD_COLLECT = {"rollout_len": 2, "n_sim": 2, "depth": 12, "max_tree_depth": 6,
                "max_episode_steps": 14}
HELD_ARENA_STEPS = 24
AZ_CKPT = "artifacts/ppo_randseat"
AZ_UNGUIDED_TIMED, AZ_GUIDED_TIMED = 2, 1
# Cuts that keep the phase inside its time (an H100 host took 253 s for
# the phase before them): the guided iteration rolls 2 of the 8 env steps
# (44 s an 8-step iteration); the profiled env steps run 4 of the 16
# simulations unguided and 1 guided (a full guided env step is 390k
# kernels, whose profile takes minutes to read); the arena's games stop at
# 400 of their 800 steps and the azmcts games after 2 steps (5.5 s a step).
AZ_GUIDED_ROLLOUT = 2
PROFILE_SIMS = {"unguided": 4, "guided": 1}
ARENA_GAMES, ARENA_STEPS = 1024, 400
AZ_ARENA = {"games": 64, "sims": 24, "steps": 2}
# mcts_moves_net's root Q, card (cuDNN bf16 torso) against the CPU, where the
# two searches' visits agree; and the share of boards whose visits may
# differ (a near-tie of PUCT scores flipped by the logits' 1e-4 difference).
NET_Q_TOL, NET_FLIP_SHARE = 2e-3, 0.05


def az_cfg(**kw):
    """``train_az.py``'s defaults (batch 1024, rollout 8, 16 sims, depth 12,
    tree depth 6, 2 minibatches, fused env)."""
    from pomcpp_tpu_torch.learner.distill import DistillConfig

    return DistillConfig(fused_env=True, **kw)


def tree_draws(gen, b, n_sim, depth, max_tree_depth, playout=True):
    import torch

    d = {"opponents": torch.randint(0, 6, (n_sim, max_tree_depth, b, 4),
                                    generator=gen, dtype=torch.int32)}
    if playout:
        d["playout"] = torch.randint(0, 6, (n_sim, depth, b, 4),
                                     generator=gen, dtype=torch.int32)
    return d


def expect_search_equal(what, card, plain) -> None:
    import torch

    for name, a, b in zip(("moves", "visits", "root_q"), card, plain):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"[search] held {what}: {name} differs "
                                 "between the card and the CPU")


def launched_since(before: dict) -> dict:
    from pomcpp_tpu_torch import _ext

    return {k: v - before[k] for k, v in _ext.LAUNCHES.items()
            if v != before[k]}


def held_net_search(dev, cs, gen, model_cpu, model_card) -> dict:
    """``mcts_moves_net`` on the card against the CPU: moves and visits
    where they agree, root Q within ``NET_Q_TOL`` there; boards whose visits
    differ are counted, each with the CPU's top-two root visit and Q gaps."""
    import torch

    from pomcpp_tpu_torch.search import mcts_moves_net

    kw = {k: HELD_PLANE[k] for k in ("n_sim", "max_tree_depth")}
    d = tree_draws(gen, cs.board.shape[0], playout=False, depth=0, **kw)
    plain = mcts_moves_net(cs, 1, model_cpu, draws=d, device="cpu", **kw)
    card = [t.cpu() for t in mcts_moves_net(cs, 1, model_card, draws=d,
                                            device=dev, **kw)]
    same = (card[1] == plain[1]).all(1)
    flips = []
    for b in (~same).nonzero()[:, 0].tolist():
        v, q = plain[1][b].sort(descending=True)[0], plain[2][b]
        top = q.sort(descending=True)[0]
        flips.append({"board": b, "moves": [int(card[0][b]),
                                            int(plain[0][b])],
                      "visit_gap": int(v[0] - v[1]),
                      "q_gap": float(top[0] - top[1])})
    q_err = float((card[2] - plain[2]).abs()[same].max()) if same.any() \
        else 0.0
    if q_err > NET_Q_TOL or len(flips) > NET_FLIP_SHARE * len(same) or \
            not torch.equal(card[0][same], plain[0][same]):
        raise AssertionError(f"[search] held mcts_moves_net: root Q {q_err}, "
                             f"{len(flips)} boards differ: {flips}")
    return {"root_q_err": q_err, "boards_differ": len(flips), "flips": flips}


def held_arena(dev, model_cpu, model_card, es) -> dict:
    """``play_games(["ppo", "simple", "lazy", "random"])`` on the card and
    on the CPU from the same games ``es`` with the same draws.  Free-running,
    the ppo slot's Gumbel-max samples may part at a near-tie of the
    perturbed logits (cuDNN's bf16 convolutions against oneDNN's); so the
    CPU run is then repeated with that slot's moves taken from the card's
    run (``moves=``), and must give the card's ``GameResults`` and every
    other slot's moves exactly."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.arena import play_games

    names, steps = ["ppo", "simple", "lazy", "random"], HELD_ARENA_STEPS
    g = es.done.shape[0]
    gen = torch.Generator().manual_seed(91)
    draws = [[torch.rand((g, 6), generator=gen),
              torch.randint(0, 5, (g,), generator=gen, dtype=torch.int32),
              None,
              torch.randint(0, 6, (g,), generator=gen, dtype=torch.int32)]
             for _ in range(steps)]
    kw = dict(seed=92, check_every=steps + 1, es=es, draws=draws)
    before = dict(_ext.LAUNCHES)
    rec_card, rec_cpu = [], []
    card = play_games(names, g, steps, nets=model_card, device=dev,
                      record=rec_card, **kw)
    got = launched_since(before)
    if dev.type == "cuda" and got != {"fsm_act_kernel": steps}:
        raise AssertionError(f"[search] held arena launched {got}")
    free = play_games(names, g, steps, nets=model_cpu, device="cpu",
                      record=rec_cpu, **kw)
    card_moves = torch.stack([m.cpu() for m in rec_card])
    cpu_moves = torch.stack(rec_cpu)
    parted = (card_moves != cpu_moves).any(2).any(0)
    rec_forced = []
    plain = play_games(names, g, steps, nets=model_cpu, device="cpu",
                       moves={0: card_moves[:, :, 0]}, record=rec_forced,
                       **kw)
    for field in ("done", "winners", "draws"):
        if not (getattr(card, field) == getattr(plain, field)).all():
            raise AssertionError(f"[search] held arena: {field} differs")
    if not torch.equal(torch.stack(rec_forced), card_moves):
        raise AssertionError("[search] held arena: the moves differ")
    done_at_entry = es.done.cpu()
    return {"games": g, "steps": steps, "launches": got,
            "done_at_entry": int(done_at_entry.sum()),
            "finished_in_window": int((torch.from_numpy(card.done)
                                       & ~done_at_entry).sum()),
            "won": int((card.winners >= 0).sum()),
            "free_running_games_parted": int(parted.sum()),
            "free_running_results_equal": bool(
                all((getattr(card, f) == getattr(free, f)).all()
                    for f in ("done", "winners", "draws")))}


def phase_search_held(dev, boards=None):
    """Every planner, the distillation collector and update and an arena
    line-up on the card against the same calls on CPU tensors, with the same
    draws.  ``boards`` (default ``SEARCH_HELD_BOARDS``): ``"kernel"`` boards
    for what launches a kernel of the port, ``"plane"`` for the plane
    engine's planners."""
    import copy

    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.learner.distill import (
        collect_search_rollout,
        distill_init,
        distill_update,
    )
    from pomcpp_tpu_torch.search import (
        lookahead_moves,
        mcts_moves,
        mcts_moves_chunk,
    )
    from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

    boards = boards or SEARCH_HELD_BOARDS
    bk, bp = boards["kernel"], boards["plane"]
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    es = learn_held_start(bk, 81)
    gen = torch.Generator().manual_seed(82)
    res = {"boards": dict(boards)}

    d = tree_draws(gen, bk, **HELD_CHUNK)
    plain = mcts_moves_chunk(es.game, 0, draws=d, device=cpu, **HELD_CHUNK)
    before = dict(_ext.LAUNCHES)
    card = mcts_moves_chunk(es.game, 0, draws=d, device=dev, **HELD_CHUNK)
    got = launched_since(before)
    want = HELD_CHUNK["n_sim"] * (HELD_CHUNK["max_tree_depth"] + 1)
    if dev.type == "cuda" and got != {"rollout_chunk_kernel": want}:
        raise AssertionError(f"[search] held mcts_moves_chunk launched {got}, "
                             f"expected {want} rollout_chunk_kernel")
    expect_search_equal("mcts_moves_chunk", card, plain)
    res["mcts_moves_chunk"] = {"boards": bk, **HELD_CHUNK, "launches": got,
                               "root_q_values": sorted(
                                   set(plain[2].flatten().tolist()))[:8]}

    cs = learn_held_start(bp, 85).game
    d = tree_draws(gen, bp, **HELD_PLANE)
    plain = mcts_moves(cs, 2, draws=d, device=cpu, **HELD_PLANE)
    expect_search_equal("mcts_moves", mcts_moves(cs, 2, draws=d, device=dev,
                                                 **HELD_PLANE), plain)
    depth, n_play = HELD_PLANE["depth"], 4
    d = {"others": torch.randint(0, 6, (bp, 6, 4), generator=gen,
                                 dtype=torch.int32),
         "playout": torch.randint(0, 6, (depth, bp, 6, n_play, 4),
                                  generator=gen, dtype=torch.int32)}
    mv_p, vals_p = lookahead_moves(cs, 3, depth=depth, n_playouts=n_play,
                                   draws=d, device=cpu)
    mv_c, vals_c = lookahead_moves(cs, 3, depth=depth, n_playouts=n_play,
                                   draws=d, device=dev)
    if not (torch.equal(mv_c.cpu(), mv_p) and torch.equal(vals_c.cpu(),
                                                          vals_p)):
        raise AssertionError("[search] held lookahead_moves differs")

    ts_cpu = restore_checkpoint(AZ_CKPT, distill_init(0, az_cfg(), cpu))
    model_card = copy.deepcopy(ts_cpu.model).to(dev)
    res["mcts_moves_net"] = held_net_search(dev, cs, gen, ts_cpu.model,
                                            model_card)

    cfg = az_cfg(**HELD_COLLECT)
    steps = cfg.rollout_len
    draws = [{"search": [tree_draws(gen, bk, cfg.n_sim, cfg.depth,
                                    cfg.max_tree_depth) for _ in range(4)],
              "uniforms": torch.rand((bk, 4, 6), generator=gen)}
             for _ in range(steps)]
    fresh = [random_cell_state(bk, generator=gen, device="cpu")
             for _ in range(steps)]
    plain = collect_search_rollout(es, cfg, None, draws=draws, fresh=fresh,
                                   device=cpu)
    before = dict(_ext.LAUNCHES)
    card = collect_search_rollout(es, cfg, None, draws=draws, fresh=fresh,
                                  device=dev)
    got = launched_since(before)
    want = {"rollout_chunk_kernel": steps * 4 * cfg.n_sim
            * (cfg.max_tree_depth + 1), "fused_env_step_kernel": steps,
            "ego_features_kernel": steps}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"[search] held collect launched {got}, "
                             f"expected {want}")
    expect_env_equal("[search] held collect final env", card[0], plain[0])
    for name, a, b in zip(("feats", "probs", "value_t", "weight"), card[1:],
                          plain[1:]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"[search] held collect: {name} differs")
    res["collect"] = {"boards": bk, **HELD_COLLECT, "launches": got,
                      "masked_rows": int((plain[4] == 0).sum()),
                      "resets": int((plain[0].game.timestep < steps).sum())}

    # One update from the checkpoint's weights and Adam state, the same
    # rows and permutation.
    flat = tuple(x.reshape((-1,) + x.shape[3:]) for x in plain[1:])
    perm = torch.randperm(flat[0].shape[0], generator=gen)
    out = []
    for d_ in (cpu, dev):
        ts = restore_checkpoint(AZ_CKPT, distill_init(0, cfg, d_))
        start = [p.detach().clone() for p in ts.model.parameters()]
        ts, metrics = distill_update(ts, tuple(x.to(d_) for x in flat), cfg,
                                     perm)
        out.append((float(metrics["loss"]),
                    [p.detach() - q for p, q in zip(ts.model.parameters(),
                                                    start)]))
    (loss_cpu, d_cpu), (loss_card, d_card) = out
    err = {"loss": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "update": max(rel_l2(a, b) for a, b in zip(d_cpu, d_card))}
    for k in err:
        if err[k] > LEARN_TOL[k]:
            raise AssertionError(f"[search] held update: {k} differs by "
                                 f"{err[k]}")
    res["update"] = {"rows": len(flat[0]),
                     "minibatches": cfg.num_minibatches,
                     "losses": [loss_card, loss_cpu], **err}
    res["arena"] = held_arena(dev, ts_cpu.model, model_card,
                              learn_held_start(bk, 87))
    res["seconds"] = time.perf_counter() - t0
    log(f"[search] held, card == CPU: mcts_moves_chunk ({bk} boards, "
        f"launches {res['mcts_moves_chunk']['launches']}), the collector "
        f"({bk} boards, launches {res['collect']['launches']}) and the "
        f"arena ({bk} games) bit for bit, mcts_moves and lookahead_moves "
        f"({bp} boards) bit for bit; {json.dumps(res)}")
    return res


class PhaseEvents:
    """CUDA events around every call of the named module functions (the
    module's own attribute is wrapped, so callers inside it are timed)."""

    def __init__(self, module, names):
        self.module, self.names, self.pairs = module, names, {}

    def __enter__(self):
        import torch

        self.saved = {n: getattr(self.module, n) for n in self.names}

        def wrap(name, fn):
            def timed(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                self.pairs.setdefault(name, []).append(ev)
                return out
            return timed

        for n, fn in self.saved.items():
            setattr(self.module, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)

    def ms(self) -> dict:
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self.pairs.items()}


def az_iteration(ts, es, cfg, expect=None):
    """One ``az_train_step`` timed on the host clock (the metrics' host
    fetch inside the window) and split by CUDA events into search
    (``distill._plan``), features + env (the rest of the collect) and
    update (``distill.distill_update``)."""
    import math

    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.learner import distill

    before = dict(_ext.LAUNCHES)
    whole = Timer()
    with PhaseEvents(distill, ("_plan", "distill_update")) as ev:
        t0 = time.perf_counter()
        with whole:
            ts, es, metrics = distill.az_train_step(ts, es, cfg)
        m = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = launched_since(before)
    if expect is not None and got != expect:
        raise AssertionError(f"[search] an iteration launched {got}, "
                             f"expected {expect}")
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"[search] metrics not finite: {m}")
    ms = ev.ms()
    total = whole.ms()
    split = {"search_ms": ms["_plan"], "update_ms": ms["distill_update"],
             "features_env_ms": total - ms["_plan"] - ms["distill_update"],
             "iteration_device_clock_ms": total}
    return ts, es, sec, m, split, got


def az_run(name, cfg, ts, timed, warm, expect, seed):
    """``warm`` + ``timed`` full-width ``az_train_step`` iterations at
    ``AZ_BATCH`` boards: env and search steps per second (the JAX script's
    formulas), the time split, launches, peak memory above what was held
    before."""
    import torch

    from pomcpp_tpu_torch.env.environment import env_reset

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    es = env_reset(seed, AZ_BATCH)
    rows = []
    for i in range(warm + timed):
        ts, es, sec, m, split, got = az_iteration(ts, es, cfg, expect)
        if i >= warm:
            rows.append((sec, m, split, got))
    steps = AZ_BATCH * cfg.rollout_len
    # Every row of the rollout goes through one forward and backward pass.
    flop = update_flop_per_row(ts.model) * steps * 4
    res = {
        "boards": AZ_BATCH, "rollout": cfg.rollout_len, "n_sim": cfg.n_sim,
        "depth": cfg.depth, "max_tree_depth": cfg.max_tree_depth,
        "guided": cfg.guided, "warm_up_iterations": warm,
        "iter_s": [r[0] for r in rows],
        "env_steps_per_s": [steps / r[0] for r in rows],
        "search_steps_per_s": [steps * 4 * cfg.n_sim * (cfg.max_tree_depth
                                                        + cfg.depth) / r[0]
                               for r in rows],
        "split_ms": [r[2] for r in rows],
        "update_flop": flop,
        "update_tflop_per_s": [flop / r[2]["update_ms"] / 1e9 for r in rows],
        "launches_per_iter": rows[-1][3],
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - held_before,
        "held_before_bytes": held_before,
        "metrics_last": rows[-1][1],
    }
    log(f"[search] {name}: {json.dumps(res)}")
    return ts, res


def search_profile_child() -> dict:
    """One env step of the unguided and of the guided collector (with
    ``PROFILE_SIMS`` simulations) at full width under ``torch.profiler``, in
    a child process of its own (this run's earlier phases already opened two
    sessions): kernels and copies per env step and per simulation, device
    time and the idle share (device time over the wall time of the same
    step run without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner.distill import (
        collect_search_rollout,
        distill_init,
    )
    from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

    out = {}
    for name, guided in (("unguided", False), ("guided", True)):
        cfg = az_cfg(rollout_len=1, guided=guided, n_sim=PROFILE_SIMS[name])
        ts = distill_init(5, cfg)
        if guided:
            ts = restore_checkpoint(AZ_CKPT, ts)
        es = env_reset(6, AZ_BATCH)

        def run():
            collect_search_rollout(es, cfg, ts.gen, ts.model)
            torch.cuda.synchronize()

        run()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            raise RuntimeError(f"[search] torch.profiler recorded no device "
                               f"activity over the {name} env step")
        device = sum(e.device_time_total for e in events) / 1e6
        top = sorted(events, key=lambda e: -e.device_time_total)[:6]
        out[name] = {"n_sim": cfg.n_sim,
                     "wall_ms_per_env_step": wall * 1e3,
                     "device_ms_per_env_step": device * 1e3,
                     "kernels_per_env_step": sum(e.count for e in events),
                     "kernels_per_sim": sum(e.count for e in events)
                     / (4 * cfg.n_sim),
                     "idle_share": 1 - device / wall,
                     "top_device_us": {e.key[:60]: e.device_time_total
                                       for e in top}}
    return out


def search_profile() -> dict:
    """``search_profile_child`` in a child process; its JSON line."""
    proc = subprocess.run([sys.executable, __file__, "--search-profile-child"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"[search] the profiling child failed: "
                           f"{proc.stderr[-2000:]}")
    line = [s for s in proc.stdout.splitlines()
            if s.startswith("SEARCH_PROFILE ")][-1]
    return json.loads(line.split(" ", 1)[1])


def plane_host_reads(dev) -> float:
    """Device-to-host reads a plane-engine step makes (``cellular_step``'s
    chain, revert and ray loops), counted by
    ``set_sync_debug_mode("warn")`` over 8 steps of 1024 boards that have
    taken 12 random steps (bombs ticking)."""
    import warnings

    import torch

    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.cellular import cellular_step

    gen = torch.Generator(device=dev).manual_seed(3)
    cs = random_cell_state(AZ_BATCH, generator=gen)
    moves = [torch.randint(0, 6, (AZ_BATCH, 4), generator=gen, device=dev,
                           dtype=torch.int32) for _ in range(20)]
    for mv in moves[:12]:
        cs = cellular_step(cs, mv)
    moves = moves[12:]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for mv in moves:
                cs = cellular_step(cs, mv)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / len(moves)


def arena_run(names, games, steps, nets, seed, search_kwargs=None):
    import torch

    from pomcpp_tpu_torch.arena import play_games

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = play_games(names, games, steps, nets=nets, seed=seed,
                     search_kwargs=search_kwargs)
    sec = time.perf_counter() - t0
    finished = int(res.done.sum())
    won0 = int((res.done & ~res.draws & (res.winners == 0)).sum())
    return {"games": games, "steps_played": res.steps, "seconds": sec,
            "game_steps_per_s": games * res.steps / sec,
            "finished": finished, "draws": int(res.draws.sum()),
            "seat0_wins": won0, "seat0_share": won0 / max(finished, 1)}


def phase_search_main(dev):
    """The search path at full width: no host read in the chunk search's
    collector, train_az.py's defaults unguided (fresh net) and guided
    (``artifacts/ppo_randseat``), the profile of one env step of each, and
    the arena."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner.distill import (
        collect_search_rollout,
        distill_init,
    )
    from pomcpp_tpu_torch.learner.ppo import PPOConfig, ppo_init
    from pomcpp_tpu_torch.utils.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    cfg = az_cfg(rollout_len=1, n_sim=2, depth=2, max_tree_depth=2)
    es = env_reset(6, 256)
    gen = torch.Generator(device=dev).manual_seed(7)
    no_host_read(lambda: collect_search_rollout(es, cfg, gen), calls=1)
    log("[search] collect_search_rollout, unguided (mcts_moves_chunk + the "
        "fused env step): no host read (set_sync_debug_mode('error'))")
    reads = plane_host_reads(dev)
    log(f"[search] the plane engine (cellular_step, uncapped) reads the "
        f"device {reads:.2f} times a step at {AZ_BATCH} boards")

    _ext.reset_launches()
    cfg = az_cfg()
    per_iter = {"rollout_chunk_kernel": cfg.rollout_len * 4 * cfg.n_sim
                * (cfg.max_tree_depth + 1),
                "fused_env_step_kernel": cfg.rollout_len,
                "ego_features_kernel": cfg.rollout_len}
    _, unguided = az_run("unguided (train_az.py defaults, fresh net)", cfg,
                         distill_init(11), AZ_UNGUIDED_TIMED, 1, per_iter,
                         12)
    cfg = az_cfg(guided=True, rollout_len=AZ_GUIDED_ROLLOUT)
    ts = restore_checkpoint(AZ_CKPT, distill_init(13, cfg))
    _, guided = az_run(f"guided (--guided --resume {AZ_CKPT}, rollout "
                       f"{AZ_GUIDED_ROLLOUT})", cfg, ts,
                       AZ_GUIDED_TIMED, 0,
                       {"fused_env_step_kernel": cfg.rollout_len,
                        "ego_features_kernel": cfg.rollout_len}, 14)

    trained = restore_checkpoint(AZ_CKPT, ppo_init(0, PPOConfig())).model
    fresh = ppo_init(0, PPOConfig()).model
    lineup = ["ppo", "simple", "simple", "simple"]
    before = dict(_ext.LAUNCHES)
    arena = {"checkpoint": arena_run(lineup, ARENA_GAMES, ARENA_STEPS,
                                     trained, 21),
             "fresh": arena_run(lineup, ARENA_GAMES, ARENA_STEPS, fresh, 21)}
    arena_launches = launched_since(before)
    played = arena["checkpoint"]["steps_played"] + \
        arena["fresh"]["steps_played"]
    if arena_launches != {"fsm_act_kernel": played}:
        raise AssertionError(f"[search] the arena launched {arena_launches}, "
                             f"expected {played} fsm_act_kernel")
    log(f"[search] arena {lineup}, {ARENA_GAMES} games x {ARENA_STEPS} "
        f"steps, {AZ_CKPT} and a fresh net in seat 0 (seed 21): "
        f"{json.dumps(arena)}")
    if not arena["checkpoint"]["seat0_share"] > arena["fresh"]["seat0_share"]:
        raise AssertionError(f"[search] the checkpoint does not beat a fresh "
                             f"net: {arena}")
    az = AZ_ARENA
    azmcts = arena_run(["azmcts", "simple", "simple", "simple"], az["games"],
                       az["steps"], trained, 22, {"n_sim": az["sims"]})
    azmcts["decisions_per_s"] = az["games"] * azmcts["steps_played"] \
        / azmcts["seconds"]
    log(f"[search] arena azmcts (n_sim {az['sims']}, tree depth 8) vs three "
        f"SimpleAgents, {az['games']} games, capped at {az['steps']} steps: "
        f"{json.dumps(azmcts)}")
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    t1 = time.perf_counter()
    prof = search_profile()
    log(f"[search] one env step under torch.profiler (child process, "
        f"{time.perf_counter() - t1:.1f} s): {json.dumps(prof)}")
    res = {"unguided": unguided, "guided": guided, "arena": arena,
           "azmcts": azmcts, "profile": prof, "plane_host_reads": reads,
           "launches": launches, "seconds": time.perf_counter() - t0}
    return res


def phase_search(dev):
    t0 = time.perf_counter()
    held = phase_search_held(dev)
    res = phase_search_main(dev)
    res["held"] = held
    log(f"[search] phase took {time.perf_counter() - t0:.1f} s")
    return res


# --- Phase 11: data parallel, resume and replays --------------------------------

DIST_WORLD = 2                       # gloo ranks sharing the one card
DIST_CHUNK_STEPS = CHUNK             # 16384 boards x 256 steps, as the main path
DIST_SEED = 41
DIST_REPS = 9                        # all-reduce timings alone (median)
DIST_OUT = "build/chip_smoke_dist"   # checkpoints of the resume runs
RESUME_ARGS = ["--batch", str(2048), "--rollout", "64", "--epochs", "1",
               "--opponent", "simple", "--learner-slots", "0", "--fused",
               "--ckpt-every", "2"]
REPLAY_BOARDS, REPLAY_STEPS = 1024, 64
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_chunk_inputs(dev):
    """The global chunk inputs on the card: boards from ``random_cell_state``
    with every 97th board finished (the first merge resets them), injected
    moves (the simple chunk's rands) and injected fresh terrain."""
    import torch

    from pomcpp_tpu_torch.core.board_gen import (
        random_board_fast,
        random_cell_state,
    )

    cs = random_cell_state(BOARDS, seed=DIST_SEED, device=dev)
    dead = cs.agent_dead.clone()
    dead[::97, 1:] = True
    cs = cs._replace(agent_dead=dead, alive_count=(4 - dead.sum(1)).int())
    gen = torch.Generator().manual_seed(DIST_SEED)
    moves = torch.randint(0, 6, (DIST_CHUNK_STEPS, BOARDS, 4), generator=gen,
                          dtype=torch.int32).to(dev)
    reset = random_board_fast(BOARDS, torch.Generator().manual_seed(7))
    return cs, moves, tuple(t.to(dev) for t in reset)


def flat_params(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def dist_child(rank: int, world: int, port: int) -> dict:
    """One gloo rank of ``DIST_WORLD`` on the card: the sharded chunks
    against the unsharded ones on its rows, and the flagship PPO iteration
    across the ranks.  Returns this rank's report (launches of the sharded
    runs, held results, times)."""
    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
    from pomcpp_tpu_torch.engine.fused_step import rollout_chunk
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner import ppo as tppo
    from pomcpp_tpu_torch.parallel import (
        boards_mesh,
        gather_batch,
        local_rows,
        shard_batch,
        shard_env_batch,
        sharded_chunk_rollout,
    )

    dev = torch.device("cuda", 0)
    mesh = boards_mesh("gloo", dev, f"tcp://localhost:{port}", rank, world)
    cs, moves, reset = dist_chunk_inputs(dev)
    rows = local_rows(BOARDS, mesh)
    launches = dict.fromkeys(_ext.LAUNCHES, 0)
    held = {}
    for policy in ("random", "simple"):
        fsm = simple_fsm_state_init(BOARDS, dev) if policy == "simple" \
            else None
        want = rollout_chunk(cs, DIST_SEED, DIST_CHUNK_STEPS, policy,
                             moves=moves, reset_boards=reset, fsm_state=fsm)
        run = sharded_chunk_rollout(mesh, DIST_CHUNK_STEPS, policy)
        _ext.reset_launches()
        got = run(shard_batch(cs, mesh), DIST_SEED,
                  fsm_state=None if fsm is None else shard_batch(fsm, mesh),
                  moves=shard_batch(moves, mesh, axis=1),
                  reset_boards=shard_batch(reset, mesh))
        torch.cuda.synchronize()
        for k, v in _ext.LAUNCHES.items():
            launches[k] += v
        if fsm is None:                  # a CellState alone
            want, got = (want,), (got,)
        bad = [f"{i}.{j}" for i, (w, g) in enumerate(zip(want, got))
               for j, (a, b) in enumerate(zip(w, g))
               if not torch.equal(a[rows], b)]
        if bad:
            raise AssertionError(f"[dist] rank {rank}: sharded {policy} "
                                 f"chunk differs from the unsharded one in "
                                 f"{bad}")
        held[f"{policy}_boards_finished_at_start"] = int(
            (cs.agent_dead[rows].sum(1) >= 3).sum())

    cfg = flagship_cfg()
    ts = tppo.ppo_init(DIST_SEED, cfg, dev, rank=rank)
    start = gather_batch(flat_params(ts.model)[None], mesh)
    es = shard_env_batch(env_reset(DIST_SEED + 1, LEARN_BATCH, device=dev),
                         mesh)
    opp = shard_batch(tppo.opponent_state_init(LEARN_BATCH, cfg, dev), mesh)
    rows_out = []

    def iteration():
        nonlocal ts, es, opp
        _ext.reset_launches()
        t0 = time.perf_counter()
        ts, es, m, opp = tppo.ppo_train_step(ts, es, cfg, opp, mesh=mesh)
        m = {k: float(v) for k, v in m.items()}
        sec = time.perf_counter() - t0
        for k, v in _ext.LAUNCHES.items():
            launches[k] += v
        rows_out.append({"sec": sec, "metrics": m})

    iteration()                      # the held iteration (and warm-up)
    after = gather_batch(flat_params(ts.model)[None], mesh)
    metrics = gather_batch(torch.tensor(
        [list(rows_out[0]["metrics"].values())], dtype=torch.float64,
        device=dev), mesh)
    iteration()                      # timed: env-steps/s of this rank
    # All-reduce time of one more update, each call between two syncs.
    spent = []
    plain = tppo.all_reduce_sum

    def timed(t, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(t, m)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    tppo.all_reduce_sum = timed
    try:
        iteration()
    finally:
        tppo.all_reduce_sum = plain
    # The same all-reduces alone, the ranks lined up by a barrier first:
    # what the update's calls cost without waiting for the other rank.
    grad = flat_params(ts.model).clone()
    scalars = torch.zeros(4, device=dev)
    alone = []
    for _ in range(DIST_REPS):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg.minibatches):
            for t in (scalars[:2], scalars[:1], grad):
                plain(t, mesh)
        plain(scalars, mesh)
        plain(scalars[:3], mesh)
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t0)
    torch.distributed.destroy_process_group()
    local = LEARN_BATCH // world
    return {
        "rank": rank,
        "held": held,
        "start_equal": bool(torch.equal(start[0], start[1])),
        "params_equal": bool(torch.equal(after[0], after[1])),
        "params_moved": bool(not torch.equal(start[0], after[0])),
        "metrics_equal": bool(torch.equal(metrics[0], metrics[1])),
        "metrics": rows_out[0]["metrics"],
        "env_steps_per_s": local * cfg.rollout_len / rows_out[1]["sec"],
        "iter_s": rows_out[1]["sec"],
        "all_reduce_ms_per_update": sum(spent) * 1e3,
        "all_reduce_alone_ms_per_update": sorted(alone)[DIST_REPS // 2] * 1e3,
        "all_reduces_per_update": len(spent),
        "gradient_floats": grad.numel(),
        "launches": launches,
    }


def nccl_child(port: int) -> dict:
    """One rank over NCCL: a flagship iteration through the data-parallel
    path against the plain path from the same start, bit for bit (the
    card's deterministic algorithms, set before CUDA starts), and a sum
    over one rank against its input."""
    import torch

    torch.use_deterministic_algorithms(True)
    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.env.environment import env_reset
    from pomcpp_tpu_torch.learner import ppo as tppo
    from pomcpp_tpu_torch.parallel import all_reduce_sum, boards_mesh

    dev = torch.device("cuda", 0)
    mesh = boards_mesh("nccl", dev, f"tcp://localhost:{port}", 0, 1)
    x = torch.randn(1 << 20, device=dev)
    identity = bool(torch.equal(all_reduce_sum(x.clone(), mesh), x))
    cfg = flagship_cfg()
    runs, launches = [], dict.fromkeys(_ext.LAUNCHES, 0)
    for m in (None, mesh):
        ts = tppo.ppo_init(DIST_SEED, cfg, dev)
        es = env_reset(DIST_SEED + 1, LEARN_BATCH, device=dev)
        opp = tppo.opponent_state_init(LEARN_BATCH, cfg, dev)
        _ext.reset_launches()
        ts, es, metrics, opp = tppo.ppo_train_step(ts, es, cfg, opp, mesh=m)
        torch.cuda.synchronize()
        if m is not None:
            launches = dict(_ext.LAUNCHES)
        runs.append((flat_params(ts.model), {k: float(v) for k, v in
                                              metrics.items()},
                     [t for t in es.game] + list(es[1:]) + list(opp)))
    (p0, m0, s0), (p1, m1, s1) = runs
    torch.distributed.destroy_process_group()
    return {"identity": identity, "params_equal": bool(torch.equal(p0, p1)),
            "metrics_equal": m0 == m1, "metrics": m1,
            "state_equal": all(torch.equal(a, b) for a, b in zip(s0, s1)),
            "launches": launches}


def resume_child(deterministic: bool) -> dict:
    """``train_ppo`` at the flagship recipe on the card: 4 straight
    iterations, then 2 and a ``--resume`` to 4, in this process; the
    metrics lines of each."""
    import contextlib
    import io
    import shutil

    import torch

    if deterministic:
        torch.use_deterministic_algorithms(True)
    from pomcpp_tpu_torch.train_ppo import main as train

    tag = "det" if deterministic else "default"
    out = {}
    for name, iters, resume in (("straight", 4, False), ("part", 2, False),
                                ("resumed", 4, True)):
        ck = f"{DIST_OUT}/{tag}_{'straight' if name == 'straight' else 'cut'}"
        if not resume:
            shutil.rmtree(ck, ignore_errors=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train(RESUME_ARGS + ["--iters", str(iters), "--ckpt-dir", ck]
                  + (["--resume"] if resume else []))
        out[name] = buf.getvalue().splitlines()
    return out


def run_children(args_list, env_extra=None, timeout=600) -> list:
    """Run ``chip_smoke.py`` children at once, their output in files under
    ``DIST_OUT``; each one's ``CHILD`` JSON line.  A child that exits
    non-zero fails the phase at once (the others, which may be waiting for
    it in a collective, are killed), and so does the time limit."""
    import os

    env = dict(os.environ, **(env_extra or {}))
    os.makedirs(DIST_OUT, exist_ok=True)
    logs = [f"{DIST_OUT}/child_{'_'.join(args)}.log" for args in args_list]
    procs = []
    try:
        for args, path in zip(args_list, logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, *args], stdout=out,
                    stderr=subprocess.STDOUT, text=True, env=env))
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for path in logs:
        with open(path) as f:
            outs.append(f.read())
    # A child that failed on its own first, then those killed here.
    for p, out, args in sorted(zip(procs, outs, args_list),
                               key=lambda x: x[0].returncode < 0):
        if p.returncode != 0:
            raise RuntimeError(f"[dist] child {args} exited {p.returncode}: "
                               f"{out[-3000:]}")
    return [json.loads([s for s in out.splitlines()
                        if s.startswith("CHILD ")][-1].split(" ", 1)[1])
            for out in outs]


def metric_rows(lines) -> list:
    skip = {"env_steps_per_s", "sec"}
    return [{k: v for k, v in json.loads(s).items() if k not in skip}
            for s in lines if s.startswith("{")]


def phase_dist_replay(dev) -> dict:
    """A 64-step game recorded on the card (``fused_step_kernel``, 1024
    boards, board 0 recorded), saved and loaded; each frame's rendering
    against the rendering of the same game stepped by the plain version on
    the CPU, and of the card's own state (``to_state`` on card tensors)."""
    import os

    import torch

    from pomcpp_tpu_torch import _ext
    from pomcpp_tpu_torch.core.board_gen import random_cell_state
    from pomcpp_tpu_torch.engine.cellular import board_of, to_state
    from pomcpp_tpu_torch.engine.fused_step import fused_step
    from pomcpp_tpu_torch.render import render_state
    from pomcpp_tpu_torch.utils.replay import (
        load_replay,
        record_game,
        replay_frame,
        save_replay,
    )

    gen = torch.Generator().manual_seed(DIST_SEED)
    moves = torch.randint(0, 6, (REPLAY_STEPS, REPLAY_BOARDS, 4),
                          generator=gen, dtype=torch.int32)
    cs = random_cell_state(REPLAY_BOARDS, seed=DIST_SEED, device=dev)
    def step(device):
        def run(game, mv):
            out = fused_step(game, mv, device=device)
            return out._replace(timestep=out.timestep + 1)
        return run

    _ext.reset_launches()
    states, mv = record_game(cs, step(None), lambda t, g: moves[t].to(dev),
                             REPLAY_STEPS)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    os.makedirs(DIST_OUT, exist_ok=True)
    path = f"{DIST_OUT}/replay.npz"
    save_replay(path, states, mv)
    loaded, mv2 = load_replay(path, board_of(random_cell_state(1, device="cpu")))
    cpu_states, _ = record_game(
        type(cs)(*(t[:1].cpu() for t in cs)), step("cpu"),
        lambda t, g: moves[t, :1], REPLAY_STEPS)
    drawn = set()
    for t in range(REPLAY_STEPS + 1):
        a = render_state(to_state(replay_frame(loaded, t)))
        b = render_state(to_state(replay_frame(cpu_states, t)))
        if a != b:
            raise AssertionError(f"[dist] replay frame {t}: the card's game "
                                 f"renders differently from the CPU's")
        drawn |= {g for g in ("●", "♨", "DEAD") if g in a}
    if render_state(to_state(board_of(cs))) != \
            render_state(to_state(replay_frame(loaded, 0))):
        raise AssertionError("[dist] to_state on card tensors renders "
                             "differently")
    if not torch.equal(mv2, moves[:, 0]):
        raise AssertionError("[dist] the replay's moves changed")
    return {"frames": REPLAY_STEPS + 1, "glyphs_seen": sorted(drawn),
            "bytes": os.path.getsize(path), "launches": launches}


def phase_dist(dev) -> dict:
    """Data parallel on the card: two gloo ranks sharing it (the sharded
    chunks at 16384 boards x 256 steps, a flagship PPO iteration), one
    NCCL rank against the plain path, resume through ``train_ppo`` with and
    without deterministic algorithms, and a replay recorded on the card."""
    import os

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    port = free_port()
    ranks = run_children([["--dist-child", str(r), str(DIST_WORLD), str(port)]
                          for r in range(DIST_WORLD)])
    for r in ranks:
        for key in ("start_equal", "params_equal", "params_moved",
                    "metrics_equal"):
            if not r[key]:
                raise AssertionError(f"[dist] rank {r['rank']}: {key} "
                                     f"failed: {r}")
    log(f"[dist] {DIST_WORLD} gloo ranks on one card: the sharded random and "
        f"simple chunks ({BOARDS} boards x {DIST_CHUNK_STEPS} steps, moves, "
        f"rands and reset terrain injected, auto-reset) equal the unsharded "
        f"ones on every rank's rows; one flagship iteration ({LEARN_BATCH} "
        f"boards x {LEARN_ROLLOUT} steps) leaves both ranks' parameters and "
        f"metrics bit-identical")
    nccl = run_children([["--nccl-child", str(free_port())]],
                        DETERMINISTIC_ENV)[0]
    if not (nccl["identity"] and nccl["params_equal"]
            and nccl["metrics_equal"] and nccl["state_equal"]):
        raise AssertionError(f"[dist] one NCCL rank: the data-parallel "
                             f"iteration differs from the plain one: {nccl}")
    log("[dist] one NCCL rank: a flagship iteration through the "
        "data-parallel path equals the plain path's bit for bit (parameters, "
        "metrics, env and opponent state); a sum over one rank is the "
        "identity")
    det = run_children([["--resume-child", "1"]], DETERMINISTIC_ENV,
                       timeout=900)[0]
    straight = metric_rows(det["straight"])
    resumed = metric_rows(det["part"]) + metric_rows(det["resumed"])
    if not any(s.startswith("resumed full bundle") for s in det["resumed"]):
        raise AssertionError(f"[dist] no bundle was resumed: {det}")
    if len(straight) != 4 or straight != resumed:
        raise AssertionError(f"[dist] resumed metrics differ from the "
                             f"straight run's: {straight} vs {resumed}")
    default = run_children([["--resume-child", "0"]], timeout=900)[0]
    default_match = metric_rows(default["straight"]) == (
        metric_rows(default["part"]) + metric_rows(default["resumed"]))
    log(f"[dist] resume at the flagship recipe: 2 + 2 iterations equal 4 "
        f"straight, bit for bit, with deterministic algorithms; with the "
        f"default algorithms they "
        f"{'also match' if default_match else 'do NOT match'}")
    replay = phase_dist_replay(dev)
    log(f"[dist] replay: {json.dumps(replay)}")
    launches = dict.fromkeys(ranks[0]["launches"], 0)
    for part in [r["launches"] for r in ranks] + [nccl["launches"],
                                                  replay["launches"]]:
        for k, v in part.items():
            launches[k] += v
    res = {
        "ranks": [{k: r[k] for k in ("rank", "env_steps_per_s", "iter_s",
                                     "all_reduce_ms_per_update",
                                     "all_reduce_alone_ms_per_update",
                                     "all_reduces_per_update",
                                     "gradient_floats", "held")}
                  for r in ranks],
        "nccl_one_rank": {k: nccl[k] for k in ("identity", "params_equal",
                                               "metrics_equal",
                                               "state_equal")},
        "resume_deterministic_match": True,
        "resume_default_match": default_match,
        "replay": {k: v for k, v in replay.items() if k != "launches"},
        "launches": launches,
        "phase_s": time.perf_counter() - t0,
    }
    log(f"[dist] per-rank env-steps/s "
        f"{[round(r['env_steps_per_s'], 1) for r in ranks]}, all-reduce ms "
        f"per update {[round(r['all_reduce_ms_per_update'], 3) for r in ranks]}"
        f" in the update (waits for the other rank included), "
        f"{[round(r['all_reduce_alone_ms_per_update'], 3) for r in ranks]} "
        f"alone after a barrier ({ranks[0]['all_reduces_per_update']} calls, "
        f"{ranks[0]['gradient_floats']} gradient floats), {DIST_WORLD} gloo "
        f"ranks sharing one card, flagship recipe, on {smi}")
    log(f"[dist] {json.dumps(res)}")
    log(f"[dist] phase took {res['phase_s']:.1f} s")
    return res


EXACT_HELD_BOARDS, EXACT_HELD_STEPS = 1024, 64
EXACT_RAGGED = (1021, 5, 1)
EXACT_RAGGED_STEPS = 24
EXACT_SIMPLE_ACTS = 32
EXACT_TIMED_BOARDS = 10000        # the census's batch
EXACT_WARM_STEPS, EXACT_TIMED_STEPS = 8, 16
# The census at the JAX script's own sizes (games, step cap, batch).
EXACT_CENSUS = {"random": (10000, 800, 10000), "simple": (5000, 800, 5000)}
# BASELINE.md:84-91 (the JAX census, round 5, on the CPU): the reference
# distribution beside the port's (the moves differ, so not equality).
BASELINE_CENSUS = {
    "random": {"games": 10000, "synced_live_board_steps": 277177,
               "first_divergences": 43, "ppm": 155,
               "per_class": [29, 10, 4, 0]},
    "simple": {"games": 5000, "synced_live_board_steps": 1157350,
               "first_divergences": 857, "ppm": 740,
               "per_class": [0, 29, 802, 49]},
}


def expect_state_equal(what: str, a, b) -> None:
    """Every field of two queue-encoded ``State`` batches, every physical
    queue slot included, bit for bit (``b`` may live on another device)."""
    import torch

    from pomcpp_tpu_torch.core.state import State

    for name, x, y in zip(State._fields, a, b):
        pairs = zip(x._fields, x, y) if name in ("bombs", "flames") \
            else [("", x, y)]
        for sub, u, v in pairs:
            if not torch.equal(u.cpu(), v.cpu()):
                raise AssertionError(f"{what}: card and CPU differ in "
                                     f"{name}{'.' + sub if sub else ''}")


def is_in_danger_cells(s):
    """bool[B, 4]: each agent stands in a live bomb's cross."""
    from pomcpp_tpu_torch.strategy.moves import danger_map

    cells = (s.agent_x + 11 * s.agent_y).long()
    return danger_map(s).gather(1, cells) > 0


def exact_start(seeds):
    """CPU exact states of the reference's boards, kick on odd indices."""
    from pomcpp_tpu_torch.divergence_census import start_states

    return start_states(list(seeds), "cpu")[0]


def held_exact_steps(dev, s, moves, what) -> None:
    """Step CPU and card copies of ``s`` through ``moves`` ([T, B, 4]),
    every State field equal after every step."""
    from pomcpp_tpu_torch.core.state import map_state
    from pomcpp_tpu_torch.engine.step import step

    card = map_state(lambda t: t.to(dev), s)
    for t in range(moves.shape[0]):
        s = step(s, moves[t])
        card = step(card, moves[t].to(dev))
        expect_state_equal(f"{what} t={t}", card, s)
    return s


def phase_exact_held(dev) -> dict:
    """The exact engine, card against the same call on CPU tensors."""
    import itertools

    import torch

    from pomcpp_tpu_torch.agents.simple import (
        simple_agent_init_batch,
        simple_agent_joint,
    )
    from pomcpp_tpu_torch.core.board_gen import random_state
    from pomcpp_tpu_torch.core.state import map_state, stack_states
    from pomcpp_tpu_torch.engine.cellular import board_of, to_state
    from pomcpp_tpu_torch.engine.step import step
    from pomcpp_tpu_torch.env.environment import (
        env_reset,
        env_step_auto_reset,
    )

    t0 = time.perf_counter()
    b, steps = EXACT_HELD_BOARDS, EXACT_HELD_STEPS
    gen = torch.Generator().manual_seed(71)
    moves = torch.randint(0, 6, (steps, b, 4), generator=gen,
                          dtype=torch.int32)
    end = held_exact_steps(dev, exact_start(range(b)), moves, "exact random")
    log(f"[exact] held: {b} reference boards (half with kick) x {steps} "
        f"random steps: card == CPU, every State field (bombs planted "
        f"{int(end.bomb_head.sum() + end.bomb_count.sum())}, alive "
        f"{int(end.alive_count.sum())})")
    sweep = torch.tensor(list(itertools.product(range(6), repeat=4)),
                         dtype=torch.int32)
    for name, cs in (("kick-heavy", kick_heavy_state("cpu")),
                     ("2x2 ring", ring_state("cpu"))):
        one = to_state(board_of(cs))
        s = stack_states([one] * sweep.shape[0])
        got = step(map_state(lambda t: t.to(dev), s), sweep.to(dev))
        expect_state_equal(f"exact 6^4 sweep, {name}", got, step(s, sweep))
    log("[exact] held: every 6^4 joint move, one step, on the kick-heavy "
        "state and the 2x2 ring: card == CPU")
    for rb in EXACT_RAGGED:
        mv = torch.randint(0, 6, (EXACT_RAGGED_STEPS, rb, 4), generator=gen,
                           dtype=torch.int32)
        held_exact_steps(dev, exact_start(range(5000, 5000 + rb)), mv,
                         f"exact ragged {rb}")
    log(f"[exact] held: ragged and tiny batches {EXACT_RAGGED} x "
        f"{EXACT_RAGGED_STEPS} steps: card == CPU")

    acts = EXACT_SIMPLE_ACTS
    rands = torch.randint(0, 5, (acts, b, 4), generator=gen,
                          dtype=torch.int32)
    plain_s = exact_start(range(b))
    card_s = map_state(lambda t: t.to(dev), plain_s)
    plain_a = simple_agent_init_batch(b, "cpu")
    card_a = simple_agent_init_batch(b, dev)
    fled = 0
    for t in range(acts):
        mv_p, cons_p, plain_a = simple_agent_joint(plain_s, plain_a, rands[t])
        mv_c, cons_c, card_a = simple_agent_joint(card_s, card_a,
                                                  rands[t].to(dev))
        expect_fsm_equal(f"exact SimpleAgent t={t}",
                         [mv_c.cpu(), cons_c.cpu(), *(x.cpu() for x in card_a)],
                         [mv_p, cons_p, *plain_a])
        fled += int((is_in_danger_cells(plain_s) & (mv_p != 0)).sum())
        plain_s = step(plain_s, torch.where(plain_s.agent_dead, 0, mv_p))
        card_s = step(card_s, torch.where(card_s.agent_dead, 0, mv_c))
        expect_state_equal(f"exact SimpleAgent play t={t}", card_s, plain_s)
    assert fled > 0, "exact SimpleAgent: no agent fled a bomb"
    log(f"[exact] held: the exact SimpleAgent, {b} boards x {acts} acts of "
        f"all four agents with injected rands: moves, consumed and agent "
        f"state card == CPU ({fled} moves out of danger), and the exact "
        f"steps of those moves")

    plain = env_reset(9, b, engine="exact", device="cpu")
    dead = torch.zeros((b, 4), dtype=torch.bool)
    dead[: b // 16, 1:] = True
    dead[b // 16: b // 8] = True
    plain = plain._replace(
        game=plain.game._replace(
            agent_dead=dead, alive_count=4 - dead.sum(1, dtype=torch.int32)),
        done=torch.arange(b) % 16 == 5)
    card = plain._replace(game=map_state(lambda t: t.to(dev), plain.game),
                          **{k: getattr(plain, k).to(dev)
                             for k in ("done", "winner", "is_draw", "key")})
    seen = dict(resets=0, wins=0, draws=0)
    for t in range(steps):
        key = torch.stack([torch.full((b,), 77), torch.arange(b),
                           torch.full((b,), t)], 1)
        fresh = random_state(key)
        seen["resets"] += int(plain.done.sum())
        nxt = env_step_auto_reset(plain, moves[t], max_steps=24, fresh=fresh,
                                  device="cpu")
        new = nxt.done & ~plain.done
        seen["wins"] += int((new & ~nxt.is_draw).sum())
        seen["draws"] += int((new & nxt.is_draw).sum())
        plain = nxt
        card = env_step_auto_reset(card, moves[t].to(dev), max_steps=24,
                                   fresh=map_state(lambda x: x.to(dev), fresh),
                                   device=dev)
        expect_state_equal(f"exact env t={t}", card.game, plain.game)
        for name in ("done", "winner", "is_draw", "key"):
            if not torch.equal(getattr(card, name).cpu(),
                               getattr(plain, name)):
                raise AssertionError(f"exact env t={t}: card and CPU differ "
                                     f"in {name}")
    assert min(seen.values()) > 0, f"exact env: {seen}"
    log(f"[exact] held: env_step_auto_reset on exact games, {b} x {steps} "
        f"with injected fresh boards and a step cap of 24: card == CPU "
        f"({seen})")
    return {"held_s": time.perf_counter() - t0}


def exact_step_profile(dev) -> dict:
    """ms per exact step at ``EXACT_TIMED_BOARDS`` boards (host clock over
    synchronised steps), PyTorch operators and host reads per step, and the
    device's idle share from ``torch.profiler`` over a few steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pomcpp_tpu_torch import trace
    from pomcpp_tpu_torch.core.state import map_state
    from pomcpp_tpu_torch.engine.step import step

    b = EXACT_TIMED_BOARDS
    gen = torch.Generator(device=dev).manual_seed(73)
    s = map_state(lambda t: t.to(dev), exact_start(range(b)))

    def moves():
        return torch.randint(0, 6, (b, 4), generator=gen, device=dev,
                             dtype=torch.int32)

    for _ in range(EXACT_WARM_STEPS):
        s = step(s, moves())
    torch.cuda.synchronize()
    reads0 = trace.COUNTERS["host_reads"]
    t0 = time.perf_counter()
    for _ in range(EXACT_TIMED_STEPS):
        s = step(s, moves())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / EXACT_TIMED_STEPS
    reads = (trace.COUNTERS["host_reads"] - reads0) / EXACT_TIMED_STEPS
    mv = moves()
    ops = device_ops(lambda: step(s, mv))
    prof_steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(prof_steps):
            s = step(s, moves())
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) / prof_steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("[exact] torch.profiler recorded no device "
                           "activity over the exact steps")
    device = sum(e.device_time_total for e in events) / prof_steps / 1e6
    return {"boards": b, "ms_per_step": wall * 1e3,
            "census_parts_ms": census_parts(dev, s),
            "operators_per_step": len(ops),
            "host_reads_per_step": reads,
            "kernels_per_step": sum(e.count for e in events) / prof_steps,
            "device_ms_per_step": device * 1e3,
            "profiled_ms_per_step": prof_wall * 1e3,
            "idle_share": 1 - device / prof_wall,
            "alive_after": int(s.alive_count.sum())}


def census_parts(dev, s) -> dict:
    """Host-clocked ms of each part of a SimpleAgent census step on the
    first ``EXACT_CENSUS["simple"]`` boards of ``s`` (synchronised after
    each part, a few steps each): the plane SimpleAgent's act, the exact
    step, the plane step, and the conversion and comparison."""
    import torch

    from pomcpp_tpu_torch.agents.simple import simple_agent_init
    from pomcpp_tpu_torch.agents.simple_cellular import simple_agent_cell_joint
    from pomcpp_tpu_torch.core.state import map_state
    from pomcpp_tpu_torch.divergence_census import _equal_boards
    from pomcpp_tpu_torch.engine.cellular import cellular_step, from_state
    from pomcpp_tpu_torch.engine.step import step

    b = EXACT_CENSUS["simple"][0]
    s = map_state(lambda t: t[:b].contiguous(), s)
    c = from_state(s)
    ps = simple_agent_init((b, 4), dev)
    gen = torch.Generator(device=dev).manual_seed(79)
    parts = dict.fromkeys(("act", "exact_step", "plane_step",
                           "convert_compare"), 0.0)
    reps = 4

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] += (time.perf_counter() - t0) * 1e3 / reps
        return out

    for _ in range(reps):
        rands = torch.randint(0, 5, (b, 4), generator=gen, device=dev,
                              dtype=torch.int32)
        mv, _, ps = timed("act", lambda: simple_agent_cell_joint(c, ps, rands))
        mv = torch.where(c.agent_dead, 0, mv).to(torch.int32)
        s2 = timed("exact_step", lambda: step(s, mv))
        c2 = timed("plane_step", lambda: cellular_step(c, mv))
        timed("convert_compare", lambda: _equal_boards(from_state(s2), c2))
        s, c = s2, from_state(s2)
    return {"boards": b, **parts}


def exact_profile() -> dict:
    """``exact_step_profile`` in a child process (``--exact-profile-child``;
    a third profiler session in one process records no device activity);
    its JSON line."""
    proc = subprocess.run([sys.executable, __file__, "--exact-profile-child"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"[exact] the profiling child failed: "
                           f"{proc.stderr[-2000:]}")
    line = [s for s in proc.stdout.splitlines()
            if s.startswith("EXACT_PROFILE ")][-1]
    return json.loads(line.split(" ", 1)[1])


def phase_exact_main(dev) -> dict:
    """The exact engine's main path at full width: the divergence census
    (random and SimpleAgent) through ``divergence_census.run_census``."""
    import torch

    from pomcpp_tpu_torch.divergence_census import run_census

    smi = nvidia_smi_line()
    prof = exact_profile()
    log(f"[exact] {prof['boards']} boards: {prof['ms_per_step']:.3f} ms per "
        f"exact step (host clock), {prof['operators_per_step']} PyTorch "
        f"operators and {prof['host_reads_per_step']:.2f} host reads per "
        f"step; torch.profiler: {prof['kernels_per_step']:.1f} kernels and "
        f"copies, {prof['device_ms_per_step']:.3f} ms of device time per "
        f"step: device idle {prof['idle_share']:.3f} of the time, on {smi}")
    parts = prof["census_parts_ms"]
    log(f"[exact] a SimpleAgent census step at {parts['boards']} boards, "
        f"host-clocked ms by part: " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items() if k != "boards")
        + f", on {smi}")
    out = {"step": prof, "census": {}}
    for policy, (games, steps, batch) in EXACT_CENSUS.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run_census(games, steps, batch, 0, policy, dev,
                         log=lambda m: log(f"[exact] census {policy}: {m}"))
        res["peak_mib_above_start"] = \
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        res["game_steps_per_s"] = res["synced_live_board_steps"] / res["seconds"]
        res["board_steps_per_s"] = res["board_steps_run"] / res["seconds"]
        live = res["synced_live_board_steps"]
        res["ppm_per_class"] = {k: 1e6 * v / max(live, 1)
                                for k, v in res["class_counts"].items()}
        ref = BASELINE_CENSUS[policy]
        log(f"[exact] census {policy}: {games} games x {steps} steps in one "
            f"batch of {batch}: {res['first_divergences']} first divergences "
            f"in {live} synced live board-steps = {res['divergence_ppm']} ppm, "
            f"per class {list(res['class_counts'].values())} "
            f"({', '.join(f'{v:.1f}' for v in res['ppm_per_class'].values())}"
            f" ppm); JAX reference distribution (BASELINE.md, other moves): "
            f"{ref['first_divergences']} in {ref['synced_live_board_steps']} "
            f"= {ref['ppm']} ppm, per class {ref['per_class']}; "
            f"unclassified {res['unclassified']}")
        log(f"[exact] census {policy}: {res['seconds']:.1f} s, "
            f"{res['lockstep_steps']} lockstep steps, "
            f"{res['game_steps_per_s']:.1f} synced game-steps/s, "
            f"{res['board_steps_per_s']:.1f} board-steps/s stepped, peak "
            f"{res['peak_mib_above_start']:.1f} MiB above the start, on {smi}")
        if res["unclassified"]:
            raise AssertionError(f"[exact] census {policy}: unclassified "
                                 f"first divergences at "
                                 f"{res['unclassified_at']}")
        out["census"][policy] = res
    return out


def phase_exact(dev) -> dict:
    """The exact conformance engine: held card-vs-CPU runs, then the
    divergence census at full width."""
    t0 = time.perf_counter()
    held = phase_exact_held(dev)
    log(f"[exact] held part took {held['held_s']:.1f} s")
    res = phase_exact_main(dev)
    res["phase_s"] = time.perf_counter() - t0
    log(f"[exact] {json.dumps(res)}")
    log(f"[exact] phase took {res['phase_s']:.1f} s")
    return res


# The exact engine's tooling at the JAX scripts' own sizes.
FUZZ_ARGS = {"states": 20, "lo": 20, "hi": 90, "n_moves": 5, "seed": 0}
FUZZ_SECONDS = 45               # the fuzz's share of the phase
DEMO_SEED, DEMO_STEPS = 0x1337, 500
# The exact SimpleAgent's act is host-bound at one board (0.34-0.45 s a
# step on the H100, PERF.md), and the CPU plays the same acts again to
# hold the game: its game is cut to this many steps to keep the phase near
# its 150 s budget and the whole script well inside its time limit.
DEMO_SIMPLE_STEPS = 32
VIEW_STEPS, VIEW_FRAMES = 120, "10:14"
DEBUG_ARGS = {"batch_index": 1, "batch": 500, "steps": 800, "seed": 0}
# Seeds the debugger's injected random moves: this batch then diverges on
# 18 board-steps (classes 1, 2 and 4, and unclassified re-divergences after
# a stacked plant), where seed 83 gave none.
DEBUG_MOVES_SEED = 85
TOOLING_OUT = "build/chip_smoke_tooling"


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tooling_fuzz(dev, smi: str) -> dict:
    """``state_fuzz`` on the card over the script's states (its seeds and
    snapshot steps, ``find_snapshots``) until ``FUZZ_SECONDS`` pass: every
    sweep held card == CPU on every dump (and against the oracle where it
    builds)."""
    import numpy as np
    import torch

    from pomcpp_tpu_torch.core.state import map_state
    from pomcpp_tpu_torch.state_fuzz import (
        find_snapshots,
        fuzz_state,
        two_steps,
    )
    from pomcpp_tpu_torch.testing.oracle import ensure_oracle, states_to_dumps

    def cpu_reference(s, mv):
        return states_to_dumps(two_steps(map_state(lambda t: t.cpu(), s), mv))

    oracle = ensure_oracle()
    log("[tooling] fuzz: the C++ oracle " + (
        f"built ({oracle}): each sweep is held against it and against the "
        f"CPU" if oracle else "is absent on this host (no reference "
        "sources for tools/build_oracle.sh): each sweep is held card == "
        "CPU only"))
    a = FUZZ_ARGS
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    sweeps = []
    for seed, snap, s in find_snapshots(a["states"], a["lo"], a["hi"],
                                        a["seed"], dev):
        stats = {}
        label = f"seed {seed} snap {snap}"
        bad = fuzz_state(s, a["n_moves"], cpu_reference, log, stats, label)
        if bad:
            raise AssertionError(f"[tooling] fuzz {label}: {bad} sequences "
                                 f"differ")
        sweeps.append(stats["sweep_ms"])
        held = " and ".join("the C++ oracle" if h == "oracle" else "the CPU"
                            for h in stats["held_by"])
        log(f"[tooling] fuzz state {len(sweeps)}/{a['states']} ({label}): "
            f"{stats['sequences']} two-step sequences held against {held}: "
            f"OK, sweep {stats['sweep_ms']:.1f} ms on {smi}")
        if time.perf_counter() - t0 > FUZZ_SECONDS:
            break
    seconds = time.perf_counter() - t0
    n = a["n_moves"] ** 6
    med = float(np.median(sweeps))
    peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
            if dev.type == "cuda" else None)
    res = {"states": len(sweeps), "of": a["states"], "sequences": n,
           "held_by": ["oracle", "cpu"] if oracle else ["cpu"],
           "sweep_ms": sweeps, "sweep_ms_median": med,
           "sequences_per_s": n / med * 1e3, "seconds": seconds,
           "peak_mib_above_start": peak}
    log(f"[tooling] fuzz: {len(sweeps)} of the script's {a['states']} states "
        f"in {seconds:.1f} s, each {n} sequences x 2 exact steps in one call: "
        f"{res['sequences_per_s']:.0f} sequences/s (median sweep "
        f"{med:.1f} ms, host clock, synchronised), peak "
        + (f"{peak:.1f} MiB above the start" if peak is not None else
           "memory not measured") + f", on {smi}")
    return res


def tooling_demo(dev, smi: str) -> dict:
    """One demo game per policy on the card, held each step against the
    same game played on the CPU (the policies draw from a CPU generator,
    so the moves and the states must agree); ms per step."""
    import torch

    from pomcpp_tpu_torch.play_demo import POLICIES, play_game, winner_line

    out = {}
    for policy in POLICIES:
        steps = DEMO_SIMPLE_STEPS if policy == "simple" else DEMO_STEPS
        card, held = [], []
        _sync(dev)
        t0 = time.perf_counter()
        final, n = play_game(DEMO_SEED, steps, policy, device=dev,
                             on_step=lambda t, s, mv: card.append((s, mv)))
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / n

        def hold(t, s, mv):
            what = f"[tooling] demo {policy} t={t}"
            if not torch.equal(card[t][1].cpu(), mv):
                raise AssertionError(f"{what}: the card's moves "
                                     f"{card[t][1].tolist()} != the CPU's "
                                     f"{mv.tolist()}")
            expect_state_equal(what, card[t][0], s)
            held.append(t)

        plain, m = play_game(DEMO_SEED, steps, policy, device="cpu",
                             on_step=hold)
        assert m == n == len(held), (policy, m, n)
        line = winner_line(final)
        assert line == winner_line(plain)
        out[policy] = {"steps": n, "ms_per_step": ms, "result": line}
        log(f"[tooling] demo {policy}: {n} steps on {dev.type}, every move "
            f"and state == the CPU's game; {ms:.2f} ms per step (host "
            f"clock, one board); {line}; on {smi}")
    return out


def tooling_viewer(dev) -> dict:
    """A replay recorded on the card and viewed from its npz, against the
    same game recorded on the CPU."""
    import contextlib
    import io
    import os

    import numpy as np

    from pomcpp_tpu_torch.replay_viewer import record, view

    os.makedirs(TOOLING_OUT, exist_ok=True)
    card_path = os.path.join(TOOLING_OUT, "card.npz")
    cpu_path = os.path.join(TOOLING_OUT, "cpu.npz")
    _, moves = record(card_path, DEMO_SEED, VIEW_STEPS, "random", dev)
    record(cpu_path, DEMO_SEED, VIEW_STEPS, device="cpu", moves=moves)
    with np.load(card_path) as a, np.load(cpu_path) as b:
        for key in a.files:
            if not np.array_equal(a[key], b[key]):
                raise AssertionError(f"[tooling] replay: card and CPU "
                                     f"recordings differ in {key}")
    texts = []
    for path in (card_path, cpu_path):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            view(path, VIEW_FRAMES)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and texts[0].count("--- step ") == 4
    log(f"[tooling] replay viewer: {VIEW_STEPS} random-policy steps recorded "
        f"on {dev.type}, == the CPU's recording of the same moves; frames "
        f"{VIEW_FRAMES} from the npz:")
    for line in texts[0].splitlines():
        log(f"[tooling]   {line}")
    return {"steps": VIEW_STEPS, "frames": VIEW_FRAMES}


def tooling_debug(dev, smi: str) -> dict:
    """``debug_divergence`` on one census batch on the card and on the CPU,
    the same injected random moves: the same report."""
    import torch

    from pomcpp_tpu_torch.debug_divergence import debug_report

    a = DEBUG_ARGS
    gen = torch.Generator().manual_seed(DEBUG_MOVES_SEED)
    moves = torch.randint(0, 6, (a["steps"], a["batch"], 4), generator=gen,
                          dtype=torch.int32)
    _sync(dev)
    t0 = time.perf_counter()
    card = debug_report(**a, device=dev, moves=moves, log=lambda m: None)
    _sync(dev)
    seconds = time.perf_counter() - t0
    plain = debug_report(**a, device="cpu", moves=moves, log=lambda m: None)
    if card != plain:
        raise AssertionError("[tooling] debug_divergence: the card's report "
                             "differs from the CPU's")
    events = [line for line in card if line.startswith("t=")]
    log(f"[tooling] debug_divergence: batch {a['batch_index']} of "
        f"{a['batch']} boards, random moves: report == the CPU's, "
        f"{len(events)} divergent board-steps, {seconds:.1f} s on "
        f"{dev.type}, on {smi}")
    for line in card[:12]:
        log(f"[tooling]   {line}")
    return {"events": len(events), "seconds": seconds}


def phase_tooling(dev) -> dict:
    """The exact engine's tooling on the card: the state fuzzer at its
    script's size, the demo, the replay viewer and the divergence debugger,
    each held against the CPU.  No kernel of the port is on this path: the
    phase fails if one launches."""
    from pomcpp_tpu_torch import _ext

    t0 = time.perf_counter()
    smi = nvidia_smi_line() if dev.type == "cuda" else "the CPU"
    before = dict(_ext.LAUNCHES)
    res = {"fuzz": tooling_fuzz(dev, smi), "demo": tooling_demo(dev, smi),
           "viewer": tooling_viewer(dev), "debug": tooling_debug(dev, smi)}
    res["launches"] = launched_since(before)
    if res["launches"]:
        raise AssertionError(f"[tooling] a kernel of the port launched on "
                             f"the exact engine's path: {res['launches']}")
    res["phase_s"] = time.perf_counter() - t0
    log(f"[tooling] {json.dumps(res)}")
    log(f"[tooling] phase took {res['phase_s']:.1f} s")
    return res


def bound_ms(board_steps: int, bytes_moved: int, rates) -> tuple[float, str]:
    """Least time: bytes over the memory rate vs one 32-bit instruction per
    state value per board-step (7 planes x 121 cells) over the issue rate
    (``rates``: ``pomcpp_tpu_torch.device.card_rates()``)."""
    t_bytes = bytes_moved / rates.hbm * 1e3
    t_ops = board_steps * 7 * 121 / rates.issue * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


HELD_PHASES = {"step": phase_step, "fsm": phase_fsm, "chunk": phase_chunk,
               "env": phase_env_held, "probes": phase_probes_held,
               "learn": phase_learn, "search": phase_search,
               "dist": phase_dist, "exact": phase_exact,
               "tooling": phase_tooling}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pomcpp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if "--search-profile-child" in sys.argv[1:]:
        print("SEARCH_PROFILE " + json.dumps(search_profile_child()))
        return 0
    if "--exact-profile-child" in sys.argv[1:]:
        print("EXACT_PROFILE " + json.dumps(exact_step_profile(dev)))
        return 0
    child = {"--dist-child": lambda a: dist_child(*map(int, a)),
             "--nccl-child": lambda a: nccl_child(int(a[0])),
             "--resume-child": lambda a: resume_child(a[0] == "1")}
    if len(sys.argv) > 1 and sys.argv[1] in child:
        print("CHILD " + json.dumps(child[sys.argv[1]](sys.argv[2:])))
        return 0
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from pomcpp_tpu_torch.device import card_rates, rates_line

    rates = card_rates()
    log(f"[device] rates: {rates_line(rates)}")

    regs = phase_build()
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    if only:
        # A partial run for development: the named held phases, no result.
        for name in only[0]:
            HELD_PHASES[name](dev)
        torch.cuda.synchronize()
        log("partial run: no result line")
        return 4
    if "--profile" in sys.argv[1:]:
        env_res = phase_env_main(dev)
        profile_env(env_res["state"], env_res["fsm_state"])
        profile_chunk_phases(smi)
        log("partial run: no result line")
        return 4
    phase_step(dev)
    phase_fsm(dev)
    phase_chunk(dev)
    main_res, inputs = phase_main(dev)
    timing = phase_timing(inputs)
    phase_env_held(dev)
    env_res = phase_env_main(dev)
    env_timing = phase_env_timing(env_res["state"])
    t0 = time.perf_counter()
    phase_probes_held(dev)
    probe_rows, probe_launches = phase_probes_main(dev)
    log(f"[probes] phase took {time.perf_counter() - t0:.1f} s")
    learn = phase_learn(dev)
    search = phase_search(dev)
    dist = phase_dist(dev)
    phase_exact(dev)
    phase_tooling(dev)
    torch.cuda.synchronize()

    paths = {"main": main_res["launches"], "env": env_res["launches"],
             "probes": probe_launches, "learn": learn["launches"],
             "search": search["launches"], "dist": dist["launches"]}

    def launches(name):
        by_path = {path: counts[name] for path, counts in paths.items()
                   if counts[name]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    main_ms = {pol: sum(v) / len(v) for pol, v in main_res["chunk_ms"].items()}
    chunk_bound, chunk_by = bound_ms(BOARDS * CHUNK, BOARDS * 2 * STATE_BYTES,
                                     rates)
    step_bound, step_by = bound_ms(
        BOARDS, BOARDS * (2 * GAME_BYTES + MOVE_BYTES), rates)
    env_bound, env_by = bound_ms(
        BOARDS, BOARDS * (2 * (GAME_BYTES + ENV_BYTES) + MOVE_BYTES), rates)
    merge_bound, merge_by = bound_ms(BOARDS, env_timing["merge_rate"]["bytes"],
                                     rates)
    simple_bound, simple_by = bound_ms(
        BOARDS * CHUNK, BOARDS * 2 * (STATE_BYTES + FSM_BYTES), rates)
    act_bound, act_by = bound_ms(BOARDS, BOARDS * ACT_BYTES, rates)
    kernels = [
        {
            "name": "rollout_chunk_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/fused_step.cu",
            "replaces": "pomcpp_tpu/engine/pallas_step.py:840",
            **launches("rollout_chunk_kernel"),
            "max_abs_err": timing["chunk"][2],
            "ms": timing["chunk"][0],
            "main_ms": {p: main_ms[p] for p in ("harmless", "random")},
            "plain_ms": timing["chunk"][1],
            "bound_ms": chunk_bound, "bound_by": chunk_by,
            "library_ms": None,
            "held_in": ["chunk", "timing"],
            "shape": f"{BOARDS} boards x {CHUNK} steps, random policy",
        },
        {
            "name": "fused_step_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/fused_step.cu",
            "replaces": "pomcpp_tpu/engine/pallas_step.py:1261",
            **launches("fused_step_kernel"),
            "max_abs_err": timing["step"][2],
            "ms": timing["step"][0],
            "entry_ms": timing["step"][3],
            "plain_ms": timing["step"][1],
            "bound_ms": step_bound, "bound_by": step_by,
            "library_ms": None,
            "held_in": ["step", "timing"],
            "shape": f"{BOARDS} boards x 1 step",
        },
        {
            "name": "fused_env_step_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/env_warp.cuh",
            "replaces": "pomcpp_tpu/engine/pallas_step.py:1261 (with the "
                        "env merge, pomcpp_tpu/env/environment.py:197)",
            **launches("fused_env_step_kernel"),
            "max_abs_err": env_timing["env_step"][2],
            "ms": env_timing["env_step"][0],
            "entry_ms": env_res["fused_ms"],
            "plain_ms": env_timing["env_step"][1],
            "bound_ms": env_bound, "bound_by": env_by,
            "library_ms": None,
            "held_in": ["env", "timing"],
            "shape": f"{BOARDS} boards x 1 env step",
        },
        {
            "name": "env_merge_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/env_warp.cuh",
            "replaces": "pomcpp_tpu/engine/pallas_step.py:1069 (the env "
                        "merge after it, pomcpp_tpu/env/environment.py:197)",
            **launches("env_merge_kernel"),
            "max_abs_err": env_timing["env_merge"][2],
            "ms": env_timing["env_merge"][0],
            **env_timing["merge_rate"],
            "entry_ms": env_res["fsm_ms"],
            "plain_ms": env_timing["env_merge"][1],
            "bound_ms": merge_bound, "bound_by": merge_by,
            "library_ms": None,
            "held_in": ["env", "timing"],
            "shape": f"{BOARDS} boards x 1 env merge",
        },
        {
            "name": "rollout_chunk_simple_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/fused_step.cu",
            "replaces": "pomcpp_tpu/engine/pallas_step.py:840 (policy simple)",
            **launches("rollout_chunk_simple_kernel"),
            "max_abs_err": timing["simple"][2],
            "ms": timing["simple"][0],
            "main_ms": main_ms["simple"],
            "plain_ms": timing["simple"][1],
            "plain_shape": f"{BOARDS} boards x {PLAIN_SIMPLE_STEPS} steps",
            "bound_ms": simple_bound, "bound_by": simple_by,
            "library_ms": None,
            "held_in": ["chunk", "timing"],
            "shape": f"{BOARDS} boards x {CHUNK} steps, simple policy",
        },
        {
            "name": "fsm_act_kernel", "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/fsm_warp.cuh",
            "replaces": "pomcpp_tpu/engine/pallas_fsm.py:357",
            **launches("fsm_act_kernel"),
            "max_abs_err": timing["fsm"][2],
            "ms": timing["fsm"][0],
            "entry_ms": timing["fsm"][3],
            "plain_ms": timing["fsm"][1],
            "bound_ms": act_bound, "bound_by": act_by,
            "library_ms": None,
            "held_in": ["fsm", "timing"],
            "shape": f"{BOARDS} boards x 1 act",
        },
    ]
    # One row per probe kernel: the sublane script's pattern of the family
    # stands for it; every pattern's numbers are listed under "patterns".
    lines = {"probe_elem_kernel": ("sublane.elem", "65 (bench), :94 (bench_big); "
                                   "scripts/microbench_layout.py:42, "
                                   "microbench_i16.py:45, "
                                   "microbench_patterns.py:108, "
                                   "microbench_reductions.py:118"),
             "probe_shift_kernel": ("sublane.roll", "65 (_kernel_roll); "
                                    "scripts/microbench_i16.py:45, "
                                    "microbench_patterns.py:108, "
                                    "microbench_reductions.py:118"),
             "probe_reduce_kernel": ("sublane.sumred", "206 (_kernel_sumred); "
                                     "scripts/microbench_patterns.py:108, "
                                     "microbench_reductions.py:118"),
             "probe_dot_tc_kernel": ("sublane.dot", "134 (_kernel_dot)"),
             "probe_dot_kernel": ("sublane.dotred", "206 (_kernel_dotred)")}
    # "ms" is the layout="cta" kernel's time and "warp_layout_ms" the
    # layout="warp" kernel's, in every probe row; the warp designs live in
    # their own header (any_plane's in probes.cu's tile kernel, dot's on
    # the tensor cores).
    warp_sources = {name: "probe_warp.cuh" for name in (
        "probe_elem_kernel", "probe_shift_kernel", "probe_reduce_kernel",
        "probe_dot_kernel")}
    for name, (lead, where) in lines.items():
        mine = [r for r in probe_rows if r["kernel"] == name]
        head = next(r for r in mine if r["pattern"] == lead)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pomcpp_tpu_torch/csrc/probes.cu",
            **({"warp_layout_source": "pomcpp_tpu_torch/csrc/"
                + warp_sources[name]} if name in warp_sources else {}),
            "replaces": f"scripts/microbench_sublane.py:{where}",
            **launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["cta_ms"], "warp_layout_ms": head["warp_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": "bytes" if head["bound_by"] == "bytes" else "operations",
            "bound_term": head["bound_by"],
            "library_ms": head["library_ms"],
            "held_in": ["probes"],
            "shape": f"{lead}: {PROBE_ROWS} rows x 128 lanes, the script's K",
            "patterns": [{k: v for k, v in r.items() if k != "kernel"}
                         for r in mine],
        })
    for row in kernels:
        # A probe row's resources are the most of both layouts' kernels; the
        # warp designs' own stand beside them.
        own = dict(regs.get(row["name"], {}))
        warp = regs.get(f"{row['name']} (warp)")
        if warp:
            row["warp_layout_resources"] = warp
            own = {k: max(v, own.get(k, 0)) for k, v in warp.items()}
        row.update(own)
    # The chunk kernel's time in this layout beside the time PERF.md holds
    # for the layout it replaced (one board per 128-thread CTA).
    log("[timing] chunk kernel, one board per warp, beside one board per CTA "
        "(CTA_LAYOUT_MS, from PERF.md): " + ", ".join(
            f"{pol} {main_ms[pol]:.3f} ms ({was} ms, "
            f"{was / main_ms[pol]:.2f}x)"
            for pol, was in CTA_LAYOUT_MS.items()) + f" on {smi}")
    step_ms = timing["step"][0]
    env_rates = {k: env_res[k] for k in ("fused", "fsm", "observe", "gym")}
    log(f"[main] steps/s: {json.dumps(main_res['steps_per_s'])} on {smi}")
    log(f"[env] env-steps/s: {json.dumps(env_rates)}; ms per env step: "
        f"fused {env_res['fused_ms']:.3f} ({ENV_STEP_MS_BEFORE['fused']} "
        f"before the env kernels), mixed-control {env_res['fsm_ms']:.3f} "
        f"({ENV_STEP_MS_BEFORE['fsm']}); the fused env step reaches "
        f"{env_res['fused'] / (BOARDS / step_ms * 1e3):.3f} of {BOARDS} "
        f"boards / {step_ms:.4f} ms step kernel, on {smi}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

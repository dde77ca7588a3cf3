"""Rollout-based lookahead and tree search over batches of boards.

Counterpart of ``pomcpp_tpu.search``.  Every planner takes the ``CellState``
of B boards and searches for one agent of each board; all B searches move
together, one batched engine step at a time:

- ``playout_value``: the value of one random playout from each board
  (1 + win bonus if the agent survives, else the fraction of the horizon it
  survived);
- ``lookahead_moves``: 1-ply expansion + flat Monte-Carlo playouts; the
  B x 6 x ``n_playouts`` playouts step as one batch;
- ``mcts_moves``: open-loop UCT over fixed-size stat tensors, leaves scored
  by ``playout_value``;
- ``mcts_moves_net``: PUCT with the actor-critic's priors and value-head
  leaves (terminal leaves score exactly -1 dead / +1 won);
- ``mcts_moves_chunk``: the counterpart of ``mcts_moves_pallas``, the UCT
  search whose engine work runs through ``rollout_chunk`` (on the card
  ``rollout_chunk_kernel<false>``): one injected-move launch per tree depth
  and one ``depth``-step launch per playout, with a binary survival (+ win
  bonus) playout value.

Two engines, as in the JAX package.  ``playout_value``, ``lookahead_moves``,
``mcts_moves`` and ``mcts_moves_net`` step with ``engine.cellular``'s
``cellular_step``, whose explosion chains run to their end (the plane
engine also on the card: it is the port of an XLA module, not a kernel's
plain version).  Only ``mcts_moves_chunk`` rides the chunk kernel, whose
chains stop after ``MAX_CHAIN_ROUNDS`` rounds a step.  The cellular
planners zero dead agents' moves; ``mcts_moves_chunk`` does not (the kernel
holds them inert), as in JAX.

The tree (``_tree_search``) is written batch-level: visit counts, value
sums, child indices and priors are ``[B, n_sim + 1, 6]`` tensors read with
``gather`` and written with ``scatter``.  Every board steps at every tree
depth and a board whose walk has stopped keeps its state, as the vmapped
scan does; backups go in simulation order, so each value sum is the JAX
package's f32 sum.

Randomness.  A planner draws all its random integers up front from its
``generator``, one call per kind: opponent moves ``i32[n_sim,
max_tree_depth, B, 4]`` and playout moves.  The ``draws=`` hook takes them
instead (see each planner for the layout), which is how the tests hand the
port the integers of JAX's key tree; it also keeps the search free of host
work per simulation.  Entry points run on ``device`` (None: the card).
"""

from __future__ import annotations

import torch

from .core.constants import AGENT_COUNT
from .core.state import I32
from .device import resolve_device
from .engine.cellular import CellState, cellular_step
from .engine.fused_step import _to_device, rollout_chunk
from .env.observation import DEFAULT_VIEW_RANGE, observe_ego
from .models.actor_critic import obs_to_features

N_MOVES = 6


def _draw(generator, shape, device) -> torch.Tensor:
    """i32 moves in [0, 6) of ``shape`` from ``generator``."""
    if generator is None:
        raise ValueError("pass a generator, or the draws")
    return torch.randint(0, N_MOVES, shape, generator=generator,
                         device=device, dtype=I32)


def _draws(draws, shapes: dict, generator, device) -> dict:
    """The draws of each kind: ``draws[kind]`` where given, else drawn."""
    out = {}
    for kind, shape in shapes.items():
        if draws is not None and kind in draws:
            t = torch.as_tensor(draws[kind]).to(device=device, dtype=I32)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draws[{kind!r}] must be i32{list(shape)}")
            out[kind] = t
        else:
            out[kind] = _draw(generator, shape, device)
    return out


def _with_own_move(agent_id: int, own, others) -> torch.Tensor:
    """``others`` (i32[..., 4]) with lane ``agent_id`` replaced by ``own``
    (i32[...])."""
    lane = torch.arange(AGENT_COUNT, device=others.device) == agent_id
    return torch.where(lane, own[..., None].to(I32), others)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded once, on every device: CUDA divides by a Python
    scalar as a multiplication by its rounded reciprocal, which can move the
    last bit, so ``d`` goes in as a tensor."""
    return x / torch.full_like(x, d)


def _keep_old(keep, old: CellState, new: CellState) -> CellState:
    """Per board: ``old`` where ``keep`` else ``new``, over every field."""
    def pick(o, n):
        return torch.where(keep.reshape((-1,) + (1,) * (o.dim() - 1)), o, n)

    return CellState(*map(pick, old, new))


def _repeat(cs: CellState, n: int) -> CellState:
    """Each board ``n`` times in a row: board b becomes rows b*n .. b*n+n-1."""
    return CellState(*(t.repeat_interleave(n, 0) for t in cs))


def _playout(cs: CellState, agent_id: int, moves) -> torch.Tensor:
    """``playout_value`` on the given moves i32[depth, B, 4]."""
    depth = moves.shape[0]
    death_t = torch.full(cs.agent_x.shape[:1], -1, dtype=I32,
                         device=moves.device)
    for t in range(depth):
        mv = torch.where(cs.agent_dead, 0, moves[t])
        cs = cellular_step(cs, mv, max_chain_rounds=None)
        died_now = cs.agent_dead[:, agent_id] & (death_t < 0)
        death_t = torch.where(died_now, t, death_t)
    alive = ~cs.agent_dead[:, agent_id]
    won = alive & (cs.alive_count == 1)
    return torch.where(alive, 1.0 + won.float(),
                       true_div(death_t.float(), depth))


def playout_value(cs: CellState, agent_id: int, generator=None,
                  depth: int = 12, draws=None, device=None) -> torch.Tensor:
    """Survival/win value of one random playout from each board -> f32[B].

    1.0 + win bonus if ``agent_id`` outlives the ``depth`` random steps
    (2.0 if it is the last one standing), else the fraction of the horizon
    it survived.  ``draws={"playout": i32[depth, B, 4]}`` replaces the
    moves.
    """
    device = resolve_device(device)
    cs = _to_device(cs, device)
    b = cs.board.shape[0]
    d = _draws(draws, {"playout": (depth, b, AGENT_COUNT)}, generator, device)
    return _playout(cs, agent_id, d["playout"])


def lookahead_moves(cs: CellState, agent_id: int, generator=None,
                    depth: int = 12, n_playouts: int = 8, draws=None,
                    device=None):
    """Best move per board by 1-ply expansion + random playouts.

    For each board and each of the 6 candidate moves: apply the candidate
    (the other agents random), then run ``n_playouts`` random playouts of
    ``depth`` steps and average the acting agent's value, summed in playout
    order as JAX's ``mean`` sums.  All B x 6 x ``n_playouts`` playouts step
    as one batch.  Returns ``(moves i32[B], vals f32[B, 6])``.  Draws:
    ``"others"`` i32[B, 6, 4] (the candidate step's other moves) and
    ``"playout"`` i32[depth, B, 6, n_playouts, 4].
    """
    device = resolve_device(device)
    cs = _to_device(cs, device)
    b = cs.board.shape[0]
    d = _draws(draws, {"others": (b, N_MOVES, AGENT_COUNT),
                       "playout": (depth, b, N_MOVES, n_playouts,
                                   AGENT_COUNT)}, generator, device)
    cand = torch.arange(N_MOVES, dtype=I32, device=device).expand(b, -1)
    moves = _with_own_move(agent_id, cand, d["others"])
    moves = torch.where(cs.agent_dead[:, None, :], 0, moves)
    cs1 = cellular_step(_repeat(cs, N_MOVES), moves.reshape(-1, AGENT_COUNT),
                        max_chain_rounds=None)
    vals = _playout(_repeat(cs1, n_playouts), agent_id,
                    d["playout"].reshape(depth, -1, AGENT_COUNT))
    vals = vals.reshape(b, N_MOVES, n_playouts)
    total = vals[..., 0]
    for p in range(1, n_playouts):
        total = total + vals[..., p]
    vals = true_div(total, n_playouts)
    return vals.argmax(1).to(I32), vals


def _row(t, node):
    """``t[b, node[b], :]`` of a [B, N, 6] tensor -> [B, 6]."""
    idx = node.long()[:, None, None].expand(-1, 1, t.shape[2])
    return t.gather(1, idx)[:, 0]


def _plane_step(cs: CellState, moves) -> CellState:
    """The cellular planners' step: dead agents' moves zeroed, chains
    uncapped."""
    return cellular_step(cs, torch.where(cs.agent_dead, 0, moves),
                         max_chain_rounds=None)


def _chunk_step(cs: CellState, moves) -> CellState:
    """One injected-move step of the chunk kernel (dead agents' moves held
    inert by the kernel)."""
    return rollout_chunk(cs, 0, 1, "random", moves=moves[None],
                         auto_reset=False, device=moves.device)


def _tree_search(root: CellState, agent_id: int, n_sim: int,
                 max_tree_depth: int, score_fn, leaf_fn, root_prior,
                 opponents, step_fn=_plane_step):
    """Open-loop array-tree search, every board of the batch at once.

    The machinery of ``mcts_moves`` (UCB1 + random playouts),
    ``mcts_moves_net`` (PUCT + value-head leaves) and ``mcts_moves_chunk``:
    per simulation the selection walk re-steps the live state from the root
    along the chosen edges (``step_fn(cs, moves)``; the other agents'
    moves: ``opponents[sim, depth]``, i32[n_sim, max_tree_depth, B, 4])
    until an unexpanded edge or ``max_tree_depth``; one node is expanded;
    the leaf's value is added to every edge of the walk.

    - ``score_fn(nv, q, prior) -> f32[B, 6]`` ranks a node's edges (nv =
      per-edge visit counts, q = mean values);
    - ``leaf_fn(leaf, sim) -> (prior f32[B, 6], value f32[B])`` evaluates
      the reached leaves and gives the expanded nodes' priors;
    - ``root_prior`` (f32[B, 6]) seeds node 0's priors.

    Returns ``(moves i32[B], root_visits i32[B, 6], root_q f32[B, 6])``;
    the move is the root visit-count argmax, IDLE for a dead agent.
    """
    b, dev = root.board.shape[0], root.board.device
    nodes = n_sim + 1            # <= 1 expansion a simulation; node 0 = root
    n_vis = torch.zeros((b, nodes, N_MOVES), dtype=I32, device=dev)
    w_sum = torch.zeros((b, nodes, N_MOVES), dtype=torch.float32, device=dev)
    child = torch.full((b, nodes, N_MOVES), -1, dtype=I32, device=dev)
    prior = torch.zeros((b, nodes, N_MOVES), dtype=torch.float32, device=dev)
    prior[:, 0] = root_prior
    n_used = torch.ones(b, dtype=torch.int64, device=dev)
    for s in range(n_sim):
        cs = root
        node = torch.zeros(b, dtype=torch.int64, device=dev)
        stopped = torch.zeros(b, dtype=torch.bool, device=dev)
        en = torch.full((b,), -1, dtype=torch.int64, device=dev)
        ea = torch.zeros(b, dtype=torch.int64, device=dev)
        path_n, path_a = [], []
        for d in range(max_tree_depth):
            nv = _row(n_vis, node).float()
            q = _row(w_sum, node) / nv.clamp_min(1.0)
            a = score_fn(nv, q, _row(prior, node)).argmax(1)
            path_n.append(torch.where(stopped, -1, node))
            path_a.append(a)
            moves = _with_own_move(agent_id, a, opponents[s, d])
            cs = _keep_old(stopped, cs, step_fn(cs, moves))
            nxt = _row(child, node).gather(1, a[:, None])[:, 0].long()
            stop_now = ~stopped & (nxt < 0)
            en = torch.where(stop_now, node, en)
            ea = torch.where(stop_now, a, ea)
            node = torch.where(stopped | stop_now, node, nxt)
            stopped = stopped | stop_now
        # Expansion: bind the fresh edge (en, ea) to node n_used.
        edge = (en.clamp_min(0) * N_MOVES + ea)[:, None]
        flat = child.view(b, -1)
        flat.scatter_(1, edge, torch.where(stopped[:, None], n_used[:, None],
                                           flat.gather(1, edge)).to(I32))
        leaf_prior, value = leaf_fn(cs, s)
        slot = n_used[:, None, None].expand(-1, 1, N_MOVES)
        prior.scatter_(1, slot, torch.where(stopped[:, None, None],
                                            leaf_prior[:, None],
                                            prior.gather(1, slot)))
        n_used = n_used + stopped.long()
        # Backup along the walk; slot -1 = unused.  Within one walk no edge
        # repeats, so one scatter per simulation adds in simulation order.
        pn, pa = torch.stack(path_n, 1), torch.stack(path_a, 1)
        valid = pn >= 0
        edges = pn.clamp_min(0) * N_MOVES + pa
        n_vis.view(b, -1).scatter_add_(1, edges, valid.to(I32))
        w_sum.view(b, -1).scatter_add_(
            1, edges, torch.where(valid, value[:, None].float(), 0.0))
    root_v = n_vis[:, 0]
    root_q = w_sum[:, 0] / root_v.float().clamp_min(1.0)
    mv = torch.where(root.agent_dead[:, agent_id], 0, root_v.argmax(1))
    return mv.to(I32), root_v, root_q


def _tree_draws(draws, n_sim, max_tree_depth, b, generator, device,
                depth=None):
    shapes = {"opponents": (n_sim, max_tree_depth, b, AGENT_COUNT)}
    if depth is not None:
        shapes["playout"] = (n_sim, depth, b, AGENT_COUNT)
    return _draws(draws, shapes, generator, device)


def _score_ucb1(c_uct: float):
    def score(nv, q, _prior):
        u = c_uct * torch.sqrt(torch.log(nv.sum(1, keepdim=True) + 1.0)
                               / nv.clamp_min(1.0))
        # Unvisited edges outrank everything, tried in move order.
        order = torch.arange(N_MOVES, dtype=torch.float32, device=nv.device)
        return torch.where(nv == 0.0, 1e9 - order, q + u)

    return score


def mcts_moves(cs: CellState, agent_id: int, generator=None, n_sim: int = 24,
               depth: int = 12, max_tree_depth: int = 8, c_uct: float = 1.25,
               draws=None, device=None):
    """UCT move per board; the whole batch searches together.

    Per simulation: walk the tree from the root by UCB1 (unvisited edges
    first, in move order), stepping the live state along the way (our move
    = the tree edge, the others = fresh random draws), until an unexpanded
    edge or ``max_tree_depth``; allocate one node; score the leaf with a
    ``depth``-step random playout (``playout_value``); add the value to
    every edge on the path.  Final move = root visit-count argmax.  Returns
    ``(moves i32[B], root_visits i32[B, 6], root_q f32[B, 6])``.  Draws:
    ``"opponents"`` i32[n_sim, max_tree_depth, B, 4], ``"playout"``
    i32[n_sim, depth, B, 4].
    """
    device = resolve_device(device)
    cs = _to_device(cs, device)
    b = cs.board.shape[0]
    d = _tree_draws(draws, n_sim, max_tree_depth, b, generator, device, depth)

    def leaf_playout(leaf, s):
        return (torch.zeros((b, N_MOVES), device=device),
                _playout(leaf, agent_id, d["playout"][s]))

    return _tree_search(cs, agent_id, n_sim, max_tree_depth,
                        _score_ucb1(c_uct), leaf_playout,
                        torch.zeros((b, N_MOVES), device=device),
                        d["opponents"])


def _net_eval(model, agent_id: int, view_range: int):
    def evaluate(cs: CellState):
        feats = obs_to_features(observe_ego(cs, agent_id,
                                            view_range=view_range),
                                view_range)
        logits, value = model(feats.reshape(feats.shape[0], -1))
        # Terminal states score exactly; the net only guesses the rest.
        dead = cs.agent_dead[:, agent_id]
        won = ~dead & (cs.alive_count == 1)
        value = torch.where(dead, -1.0, torch.where(won, 1.0, value))
        return torch.softmax(logits, -1), value

    return evaluate


@torch.no_grad()
def mcts_moves_net(cs: CellState, agent_id: int, model, generator=None,
                   n_sim: int = 32, max_tree_depth: int = 8,
                   c_puct: float = 1.5, view_range: int | None = None,
                   draws=None, device=None):
    """AlphaZero-style PUCT search guided by the actor-critic ``model``.

    The tree of ``mcts_moves``, but expanded nodes store the policy head's
    move priors (selection score Q + c_puct * P * sqrt(sum N) / (1 + n)) and
    a leaf is scored by the value head -- except terminal leaves, which
    score exactly (+1 won / -1 dead).  One forward of B rows evaluates the
    root and one each simulation.  ``view_range`` must be the model's
    training view (None: the default radius).  The model must be on
    ``device``.  Returns ``(moves i32[B], root_visits i32[B, 6], root_q
    f32[B, 6])``.  Draws: ``"opponents"`` i32[n_sim, max_tree_depth, B, 4].
    """
    if view_range is None:
        view_range = DEFAULT_VIEW_RANGE
    device = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != device.type:
        raise ValueError(f"the model is on {where}, the search on {device}")
    cs = _to_device(cs, device)
    b = cs.board.shape[0]
    d = _tree_draws(draws, n_sim, max_tree_depth, b, generator, device)
    net_eval = _net_eval(model, agent_id, view_range)

    def score_puct(nv, q, prior):
        return q + c_puct * prior * (torch.sqrt(nv.sum(1, keepdim=True) + 1.0)
                                     / (1.0 + nv))

    return _tree_search(cs, agent_id, n_sim, max_tree_depth, score_puct,
                        lambda leaf, _s: net_eval(leaf), net_eval(cs)[0],
                        d["opponents"])


def mcts_moves_chunk(cs: CellState, agent_id: int, generator=None,
                     n_sim: int = 24, depth: int = 12,
                     max_tree_depth: int = 8, c_uct: float = 1.25,
                     draws=None, device=None):
    """``mcts_moves`` with its engine work on the chunk kernel.

    Counterpart of ``mcts_moves_pallas``: the same UCT tree policy, batch
    level, where each tree depth of the selection walk is ONE
    ``rollout_chunk(cs, 0, steps=1, moves=..., auto_reset=False)`` for the
    whole batch and each playout ONE ``rollout_chunk(leaf, 0, steps=depth,
    moves=..., auto_reset=False)``: on the card ``n_sim * (max_tree_depth +
    1)`` launches of ``rollout_chunk_kernel<false>`` a call, and no host
    read.  Dead agents' moves are not zeroed (the kernel holds them inert).
    The playout value is binary survival plus the win bonus, in {0, 1, 2}:
    the chunk reports the final state, not per-step death times.  Returns
    ``(moves i32[B], root_visits i32[B, 6], root_q f32[B, 6])``.  Draws:
    ``"opponents"`` i32[n_sim, max_tree_depth, B, 4], ``"playout"``
    i32[n_sim, depth, B, 4].
    """
    device = resolve_device(device)
    cs = _to_device(cs, device)
    b = cs.board.shape[0]
    d = _tree_draws(draws, n_sim, max_tree_depth, b, generator, device, depth)

    def leaf_playout(leaf, s):
        # Playout: one chunk launch, the drawn moves injected.
        fin = rollout_chunk(leaf, 0, depth, "random", moves=d["playout"][s],
                            auto_reset=False, device=device)
        alive = ~fin.agent_dead[:, agent_id]
        value = alive.float() + (alive & (fin.alive_count == 1)).float()
        return torch.zeros((b, N_MOVES), device=device), value

    return _tree_search(cs, agent_id, n_sim, max_tree_depth,
                        _score_ucb1(c_uct), leaf_playout,
                        torch.zeros((b, N_MOVES), device=device),
                        d["opponents"], _chunk_step)

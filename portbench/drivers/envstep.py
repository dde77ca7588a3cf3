"""A synchronous actor loop over the mixed-control env step: one call of
``env.environment.env_step_auto_reset_batch_fsm`` a step on the whole
batch, the learner's lanes drawn on the card from the run's seed, the
others acted by the in-kernel SimpleAgent; the caller resets the FSM rows
of boards that were done, as the learner does, and fetches the step's done
flags, winners and deaths (what its rewards are made of) to the host
before the next call: a step's latency runs from its call to the end of
that fetch.

Traffic parameters: ``learner_slots``, ``learner_moves`` (moves drawn
uniformly from ``[0, learner_moves)``), ``max_steps``, ``warmup_calls``,
``launches`` and ``check`` (``calls`` sampled from the window, ``boards``
drawn at random in each and up to ``done_boards`` more among the boards
that reset in that step).  The configuration gives ``boards``.
"""

from __future__ import annotations

import random
import time

import torch

from ..reference import env as ref_env
from ..reference import rules
from ..reference.simple_agent import FsmState
from .common import Context, Record, Sample, board_sample, call_seed, splitmix64


def port_program(ctx: Context):
    """The port's entry point, as a user calls it: ``device=None`` on the
    card."""
    from pomcpp_tpu_torch.env.environment import env_step_auto_reset_batch_fsm

    slots, max_steps = tuple(ctx.traffic["learner_slots"]), ctx.traffic["max_steps"]
    device = None if ctx.device.type == "cuda" else ctx.device

    def call(es, moves, fsm, seed):
        return env_step_auto_reset_batch_fsm(es, moves, fsm, slots, seed,
                                             max_steps=max_steps, device=device)

    return call


def control(ctx: Context, move_rounds: int = 1):
    """The plain reference in the port's place with the movement chain cut
    to ``move_rounds`` rounds of its fixed point."""
    slots, max_steps = tuple(ctx.traffic["learner_slots"]), ctx.traffic["max_steps"]

    def call(es, moves, fsm, seed):
        b = es.done.shape[0]
        seeds = torch.full((b,), seed, dtype=torch.int64, device=ctx.device)
        boards = torch.arange(b, dtype=torch.int64, device=ctx.device)
        es_ref = ref_env.EnvState(rules.CellState(*es.game), *es[1:])
        return ref_env.mixed_step(es_ref, moves, FsmState(*fsm), slots, seeds,
                                  boards, max_steps, move_rounds)

    return call


def _reset_rows(done, fresh, state):
    """``fresh`` where ``done`` (per board) else ``state``, leaf-wise."""
    d = done[:, None]
    return type(state)(*(torch.where(d, f, s) for f, s in zip(fresh, state)))


def _flat(es, fsm):
    return list(es.game) + list(es[1:]) + list(fsm)


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.boards = ctx.config["boards"]
        self.program = ctx.program or port_program(ctx)

    def _moves(self, es):
        mv = torch.randint(0, self.t["learner_moves"], (self.boards, 4),
                           generator=self.gen, device=self.ctx.device,
                           dtype=torch.int32)
        return torch.where(es.game.agent_dead, 0, mv)

    def _step(self, es, fsm, seed):
        mv = self._moves(es)
        a = time.perf_counter()
        es2, fsm2 = self.program(es, mv, fsm, seed)
        b = time.perf_counter()
        fsm_next = _reset_rows(es.done, self.fresh_fsm, fsm2)
        host = torch.cat([es2.done[:, None].to(torch.int32),
                          es2.winner[:, None].to(torch.int32),
                          es2.game.agent_dead.to(torch.int32)], 1).cpu()
        c = time.perf_counter()
        return mv, es2, fsm2, fsm_next, host, (a, b, c)

    def setup(self) -> None:
        from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init
        from pomcpp_tpu_torch.env.environment import env_reset

        ctx, dev = self.ctx, self.ctx.device
        if dev.type == "cuda":
            from pomcpp_tpu_torch import _ext

            _ext.lib()
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.es = env_reset(ctx.seed, self.boards, device=dev)
        self.fsm = simple_fsm_state_init(self.boards, dev)
        self.fresh_fsm = simple_fsm_state_init(self.boards, dev)
        for k in range(self.t["warmup_calls"]):
            _, self.es, _, self.fsm, _, _ = self._step(
                self.es, self.fsm, call_seed(ctx.seed, -1 - k))
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def window(self, rec: Record) -> None:
        from pomcpp_tpu_torch import _ext

        ctx, t = self.ctx, self.t
        sample = Sample(t["check"]["calls"], ctx.seed)
        before = dict(_ext.LAUNCHES)
        es, fsm = self.es, self.fsm
        del self.es, self.fsm
        t0 = rec.first_call = time.perf_counter()
        k = 0
        while True:
            seed = call_seed(ctx.seed, k)
            mv, es2, fsm2, fsm_next, _, (a, b, c) = self._step(es, fsm, seed)
            rec.span("env.call", a, b)
            rec.span("env.reset_fsm_fetch", b, c)
            rec.enqueue_s.append(b - a)
            rec.latencies_s.append(c - a)
            sample.offer((k, seed, es, fsm, mv, es2, fsm2))
            es, fsm = es2, fsm_next
            k += 1
            if ctx.calls is not None:
                if k >= ctx.calls:
                    break
            elif time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = time.perf_counter()
        rec.window_s = t1 - t0
        rec.calls = k
        rec.work = float(k * self.boards)
        rec.launches = {n: _ext.LAUNCHES[n] - before[n] for n in before}
        self.sample = sample.kept

    def check(self, rec: Record) -> list:
        """Replay the sampled steps' sampled boards through the reference
        and count the values (game, env and FSM state) that differ."""
        ctx, t = self.ctx, self.t
        dev = ctx.device
        ins, outs, moves, seeds, boards, calls = [], [], [], [], [], []
        for k, seed, es, fsm, mv, es2, fsm2 in self.sample:
            idx_list = board_sample(ctx.seed, k, self.boards,
                                    t["check"]["boards"])
            done = es.done.nonzero()[:, 0].tolist()
            rng = random.Random(splitmix64(call_seed(ctx.seed, k) ^ 0xD0E))
            extra = [i for i in done if i not in set(idx_list)]
            idx_list = sorted(idx_list + rng.sample(
                extra, min(len(extra), t["check"]["done_boards"])))
            idx = torch.tensor(idx_list, dtype=torch.int64, device=dev)
            ins.append([x.index_select(0, idx) for x in _flat(es, fsm)])
            outs.append([x.index_select(0, idx) for x in _flat(es2, fsm2)])
            moves.append(mv.index_select(0, idx))
            seeds.append(torch.full((len(idx_list),), seed, dtype=torch.int64,
                                    device=dev))
            boards.append(idx)
            calls.append(len(idx_list))
        self.sample = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cat = [torch.cat(col) for col in zip(*ins)]
        got = [torch.cat(col) for col in zip(*outs)]
        n_game = len(rules.CellState._fields)
        es_ref = ref_env.EnvState(rules.CellState(*cat[:n_game]),
                                  *cat[n_game:n_game + 4])
        ref_es, ref_fsm = ref_env.mixed_step(
            es_ref, torch.cat(moves), FsmState(*cat[n_game + 4:]),
            tuple(t["learner_slots"]), torch.cat(seeds),
            torch.cat(boards), t["max_steps"])
        want = _flat(ref_es, ref_fsm)
        bad_rows = torch.zeros(sum(calls), dtype=torch.bool, device=dev)
        mismatched = 0
        for w, g in zip(want, got):
            diff = w.to(torch.int64) != g.to(torch.int64)
            mismatched += int(diff.sum())
            bad_rows |= diff.reshape(diff.shape[0], -1).any(1)
        rec.failed = sum(bool(part.any()) for part in bad_rows.split(calls))
        return [("mismatched_values", mismatched, 0),
                ("boards_compared", sum(calls), None)]

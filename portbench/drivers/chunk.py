"""Self-play chunks in a closed loop: ``engine.fused_step.rollout_chunk``
called back to back on one batch of boards, each call under a fresh seed
drawn from the run's, at most ``INFLIGHT`` calls queued ahead of the card;
the window ends with a host fetch.

Traffic parameters: ``policy`` (``harmless``, ``random`` or ``simple``),
``steps`` a call, ``warmup_calls``, ``launches`` (the kernels a call must
launch), ``roofline.kernel`` (the kernel whose device time the roofline
reads) and ``check`` (``calls`` sampled from the window, ``boards``
compared in each).  The configuration gives ``boards``.
"""

from __future__ import annotations

import collections
import time

import torch

from ..peaks import chunk_bytes
from ..reference import chunk as ref_chunk
from ..reference import rules
from ..reference.simple_agent import FsmState
from .common import Context, Record, Sample, board_sample, call_seed

# Calls queued ahead of the card.  The loop never reads the device, so
# without a bound the host would queue the whole window's calls, each
# holding its own output batch, and fill the card; two keep it busy.
INFLIGHT = 2


def port_program(ctx: Context):
    """The port's entry point, as a user calls it: ``device=None`` on the
    card."""
    from pomcpp_tpu_torch.engine.fused_step import rollout_chunk

    steps, policy = ctx.traffic["steps"], ctx.traffic["policy"]
    device = None if ctx.device.type == "cuda" else ctx.device

    def call(cs, seed, fsm):
        if fsm is None:
            return rollout_chunk(cs, seed, steps, policy, device=device), None
        return rollout_chunk(cs, seed, steps, policy, device=device,
                             fsm_state=fsm)

    return call


def control(ctx: Context, move_rounds: int = 1):
    """The plain reference in the port's place with the movement chain cut
    to ``move_rounds`` rounds of its fixed point."""
    steps, policy = ctx.traffic["steps"], ctx.traffic["policy"]

    def call(cs, seed, fsm):
        b = cs.board.shape[0]
        seeds = torch.full((b,), seed, dtype=torch.int64, device=ctx.device)
        boards = torch.arange(b, dtype=torch.int64, device=ctx.device)
        out = ref_chunk.rollout_chunk(
            rules.CellState(*cs), seeds, boards, steps, policy,
            fsm_state=None if fsm is None else FsmState(*fsm),
            move_rounds=move_rounds)
        return (out, None) if fsm is None else out

    return call


def _rows(fields, idx):
    return [t.index_select(0, idx) for t in fields]


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.boards = ctx.config["boards"]
        self.program = ctx.program or port_program(ctx)

    def setup(self) -> None:
        from pomcpp_tpu_torch.core.board_gen import random_cell_state
        from pomcpp_tpu_torch.engine.fsm import simple_fsm_state_init

        ctx, dev = self.ctx, self.ctx.device
        if dev.type == "cuda":
            from pomcpp_tpu_torch import _ext

            _ext.lib()
        self.cs = random_cell_state(self.boards, ctx.seed, device=dev)
        self.fsm = simple_fsm_state_init(self.boards, dev) \
            if self.t["policy"] == "simple" else None
        for k in range(self.t["warmup_calls"]):
            self.cs, self.fsm = self.program(self.cs, call_seed(ctx.seed, -1 - k),
                                             self.fsm)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def window(self, rec: Record) -> None:
        from pomcpp_tpu_torch import _ext

        ctx, t = self.ctx, self.t
        cuda = ctx.device.type == "cuda"
        sample = Sample(t["check"]["calls"], ctx.seed)
        queued = collections.deque()
        before = dict(_ext.LAUNCHES)
        cs, fsm = self.cs, self.fsm
        del self.cs, self.fsm
        t0 = rec.first_call = time.perf_counter()
        k = 0
        while True:
            seed = call_seed(ctx.seed, k)
            a = time.perf_counter()
            out, fsm_out = self.program(cs, seed, fsm)
            b = time.perf_counter()
            rec.span("chunk.call", a, b)
            sample.offer((k, seed, cs, fsm, out, fsm_out))
            cs, fsm = out, fsm_out
            k += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
                if len(queued) > INFLIGHT:
                    w = time.perf_counter()
                    queued.popleft().synchronize()
                    rec.span("chunk.wait", w, time.perf_counter())
            if ctx.calls is not None:
                if k >= ctx.calls:
                    break
            elif time.perf_counter() - t0 >= ctx.seconds:
                break
        f = time.perf_counter()
        int(cs.alive_count.sum())             # the host fetch that ends it
        t1 = time.perf_counter()
        rec.span("chunk.fetch", f, t1)
        rec.window_s = t1 - t0
        rec.calls = k
        rec.work = float(k * self.boards * t["steps"])
        rec.launches = {n: _ext.LAUNCHES[n] - before[n] for n in before}
        rec.roofline = {
            "kernel": t["roofline"]["kernel"],
            "board_steps": self.boards * t["steps"],
            "bytes": chunk_bytes(self.boards, t["policy"]),
        }
        self.sample = sample.kept

    def check(self, rec: Record) -> list:
        """Replay the sampled calls' sampled boards through the reference
        and count the state values (game and FSM) that differ."""
        ctx, t = self.ctx, self.t
        dev = ctx.device
        ins, outs, seeds, boards, calls = [], [], [], [], []
        for k, seed, cs, fsm, out, fsm_out in self.sample:
            idx_list = board_sample(ctx.seed, k, self.boards,
                                    t["check"]["boards"])
            idx = torch.tensor(idx_list, dtype=torch.int64, device=dev)
            fin = list(cs) + (list(fsm) if fsm is not None else [])
            fout = list(out) + (list(fsm_out) if fsm_out is not None else [])
            ins.append(_rows(fin, idx))
            outs.append(_rows(fout, idx))
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
        fsm_in = FsmState(*cat[n_game:]) if len(cat) > n_game else None
        ref = ref_chunk.rollout_chunk(
            rules.CellState(*cat[:n_game]), torch.cat(seeds),
            torch.cat(boards), t["steps"], t["policy"],
            fsm_state=fsm_in)
        want = list(ref) if fsm_in is None else list(ref[0]) + list(ref[1])
        bad_rows = torch.zeros(sum(calls), dtype=torch.bool, device=dev)
        mismatched = 0
        for w, g in zip(want, got):
            diff = w.to(torch.int64) != g.to(torch.int64)
            mismatched += int(diff.sum())
            bad_rows |= diff.reshape(diff.shape[0], -1).any(1)
        rec.failed = sum(bool(part.any()) for part in bad_rows.split(calls))
        return [("mismatched_values", mismatched, 0),
                ("boards_compared", sum(calls), None)]

"""PPO training iterations back to back: one call of
``learner.ppo.ppo_train_step`` an iteration on one ``TrainState`` and one
batch of boards (collect, GAE, update), each iteration ended by the host
fetch of its metrics before the next, as ``train_ppo.py`` does (a closed
loop).  The learner's slots play against the in-kernel SimpleAgent on the
fused mixed-control env step.

The window counts a call a rollout step (``rec.calls``), so that the
launch check holds the env step's kernels to one launch a rollout step;
``rec.work`` is boards x rollout steps of the completed iterations.

Traffic parameters: ``steps`` (rollout steps an iteration), ``warmup_calls``
(iterations in set-up), ``launches`` and ``check``: ``calls`` iterations
sampled from the window, ``boards`` boards of each replayed, ``draw_gap``
and ``limits`` (see ``Driver.check``).  The configuration gives ``boards``, the model's widths
(``model``) and the learner's settings (``ppo``: ``PPOConfig`` fields; the
traffic's ``steps`` is the rollout length).  ``ctx.calls`` counts
iterations.

The parameters and Adam's state are updated in place, so before each
iteration the window snapshots them, and both generators' states, into
one flat device tensor and two host states; the iteration's records
(``ppo_train_step(record=...)``) and its inputs and outputs are held by
reference.  The check replays a sampled iteration from its snapshot.
"""

from __future__ import annotations

import functools
import time

import torch

from ..reference import env as ref_env
from ..reference import ppo as ref_ppo
from ..reference import rules
from ..reference.chunk import _fresh_fsm
from ..reference.simple_agent import FsmState
from .common import Context, Record, Sample, board_sample

BF16 = torch.bfloat16
# Rows a block of the reference's f32 forward over the whole batch: bounds
# each layer's activations (64 x 9 x 9 f32 values a row) to 0.34 GB.
REF_BLOCK_ROWS = 16384


def ppo_config(ctx: Context):
    """The configuration's ``PPOConfig`` at the traffic's rollout length."""
    from pomcpp_tpu_torch.learner.ppo import PPOConfig

    fields = dict(ctx.config["ppo"], rollout_len=ctx.traffic["steps"])
    fields["learner_slots"] = tuple(fields["learner_slots"])
    return PPOConfig(**fields)


def port_program(ctx: Context):
    """The port's entry point, as ``train_ppo.py`` calls it: ``device=None``
    on the card."""
    from pomcpp_tpu_torch.learner.ppo import ppo_train_step

    cfg = ppo_config(ctx)
    device = None if ctx.device.type == "cuda" else ctx.device

    def call(ts, es, opp, record):
        return ppo_train_step(ts, es, cfg, opp, device=device, record=record)

    return call


def _fp8(x):
    """``x`` (bf16) rounded to float8_e4m3fn, gradient passed straight
    through."""
    return x + (x.to(torch.float8_e4m3fn).to(BF16) - x).detach()


def fp8_forward(model, features):
    """``ActorCritic.forward`` one precision below the configuration's: every
    bf16 value of the torso -- its input, its kernels, each layer's output,
    the hidden layer the f32 heads read -- rounded to float8_e4m3fn (the
    biases are added in bf16, as an fp8 product's epilogue adds them)."""
    from pomcpp_tpu_torch.models.actor_critic import N_FEATURES

    w = model.width
    x = _fp8(features.reshape(-1, w, w, N_FEATURES).to(BF16)).permute(0, 3, 1, 2)
    for conv in model.convs:
        x = torch.nn.functional.conv2d(x, _fp8(conv.weight.to(BF16)), None,
                                       padding=1)
        x = _fp8(torch.relu(x + conv.bias.to(BF16)[:, None, None]))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.nn.functional.linear(x, _fp8(model.dense.weight.to(BF16)))
    h = _fp8(torch.relu(x + model.dense.bias.to(BF16))).float()
    logits = torch.nn.functional.linear(h, model.policy.weight) + model.policy.bias
    value = torch.nn.functional.linear(h, model.value.weight) + model.value.bias
    return logits, value[:, 0]


def control(ctx: Context):
    """The program with the actor-critic's torso run through float8_e4m3fn
    (``fp8_forward``), one precision below the configuration's."""
    base = port_program(ctx)

    def call(ts, es, opp, record):
        ts.model.forward = functools.partial(fp8_forward, ts.model)
        return base(ts, es, opp, record)

    return call


def fetch(metrics) -> dict:
    """The iteration's metrics on the host, as ``train_ppo.py`` reads them
    after each iteration (the first read waits for the device)."""
    return {n: float(v) for n, v in metrics.items()}


def snapshot(ts) -> dict:
    """The parameters and Adam's moments as one flat device tensor (params,
    then the first moments, then the second, each in parameter order; the
    moments left out before Adam's first step), Adam's step count and both
    generators' states."""
    params = list(ts.model.parameters())
    state = [ts.optimizer.state.get(p) for p in params]
    leaves = params
    step = 0
    if state[0]:
        leaves = params + [s["exp_avg"] for s in state] + \
            [s["exp_avg_sq"] for s in state]
        step = int(state[0]["step"])
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    return {"flat": flat, "step": step, "gen": ts.gen.get_state(),
            "host_gen": ts.host_gen.get_state()}


def unflatten(flat, like) -> list:
    """The leading leaves of ``flat``, in the shapes of ``like``."""
    sizes = [p.numel() for p in like]
    parts = flat[:sum(sizes)].split(sizes)
    return [part.view_as(p) for part, p in zip(parts, like)]


def rel_l2(got, want, before) -> float:
    """The relative L2 of the change from ``before`` that ``got`` made,
    against the one ``want`` made, over the leaves together."""
    err = sum(float((g - w).square().sum()) for g, w in zip(got, want))
    ref = sum(float((w - b).square().sum()) for w, b in zip(want, before))
    return (err / max(ref, 1e-60)) ** 0.5


def leaf_row(name, got, want, before, m_got, m_want, m_before,
             lr: float) -> dict:
    """One leaf's readings: the RMS of the program's parameters less the
    reference's after the iteration (``diff_rms_lr``) and of the
    reference's change (``ref_step_rms_lr``), both in units of ``lr``; the
    relative L2 of the change; and the RMS of the reference's gradients as
    they enter Adam's first moment (``ref_grad_rms``: that part of the
    moment over ``1 - b1``) with the relative L2 of the program's."""
    scale = lr * got.numel() ** 0.5
    m_ref = (m_want - m_before) / (1 - ref_ppo.ADAM_B1)
    return {"leaf": name, "numel": got.numel(),
            "diff_rms_lr": float(torch.linalg.vector_norm(got - want)) / scale,
            "ref_step_rms_lr": float(torch.linalg.vector_norm(want - before))
            / scale,
            "rel_l2": rel_l2([got], [want], [before]),
            "ref_grad_rms": float(torch.linalg.vector_norm(m_ref))
            / got.numel() ** 0.5,
            "grad_rel_l2": rel_l2([m_got], [m_want], [m_before])}


def _flat(es, fsm) -> list:
    return list(es.game) + list(es[1:]) + list(fsm)


def _ne(a, b) -> int:
    return int((a.to(torch.int64) != b.to(torch.int64)).sum())


def _bits(x):
    return x.contiguous().view(torch.int16)


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = ctx.traffic
        self.boards = ctx.config["boards"]
        self.steps = ctx.traffic["steps"]
        self.cfg = ppo_config(ctx)
        self.program = ctx.program or port_program(ctx)

    def setup(self) -> None:
        from pomcpp_tpu_torch.env.environment import env_reset
        from pomcpp_tpu_torch.learner.ppo import opponent_state_init, ppo_init

        ctx, dev = self.ctx, self.ctx.device
        if dev.type == "cuda":
            from pomcpp_tpu_torch import _ext

            _ext.lib()
        ts = ppo_init(ctx.seed, self.cfg, dev)
        n = sum(p.numel() for p in ts.model.parameters())
        if n != ctx.config["model"]["parameters"]:
            raise ValueError(f"the model has {n} parameters, the "
                             f"configuration {ctx.config['model']['parameters']}")
        es = env_reset(ctx.seed, self.boards, device=dev)
        opp = opponent_state_init(self.boards, self.cfg, dev)
        for _ in range(self.t["warmup_calls"]):
            ts, es, metrics, opp = self.program(ts, es, opp, None)
            fetch(metrics)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.state = (ts, es, opp)

    def window(self, rec: Record) -> None:
        from pomcpp_tpu_torch import _ext

        ctx = self.ctx
        sample = Sample(self.t["check"]["calls"], ctx.seed)
        before = dict(_ext.LAUNCHES)
        ts, es, opp = self.state
        del self.state
        rec.roofline = {"model": ctx.config["model"]}
        snap_s, prev, k = 0.0, None, 0
        t0 = rec.first_call = time.perf_counter()
        while True:
            a = time.perf_counter()
            snap = snapshot(ts)
            b = time.perf_counter()
            if prev is not None:
                prev["after"] = snap["flat"]
            record = {}
            item = {"k": k, "es": es, "opp": opp, "snap": snap,
                    "record": record}
            ts, es, metrics, opp = self.program(ts, es, opp, record)
            c = time.perf_counter()
            fetch(metrics)
            d = time.perf_counter()
            rec.span("train.snapshot", a, b)
            rec.span("train.call", b, c)
            rec.span("train.fetch", c, d)
            item.update(es2=es, opp2=opp)
            sample.offer(item)
            prev, snap_s, k = item, snap_s + b - a, k + 1
            if ctx.calls is not None:
                if k >= ctx.calls:
                    break
            elif time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = time.perf_counter()
        rec.window_s = t1 - t0
        rec.calls = k * self.steps
        rec.work = float(k * self.steps * self.boards)
        rec.launches = {n: _ext.LAUNCHES[n] - before[n] for n in before}
        prev["after"] = snapshot(ts)["flat"]
        self.leaves = [(n, p.detach()) for n, p in ts.model.named_parameters()]
        self.snapshot_ms = 1e3 * snap_s / k
        self.sample = sample.kept

    def check(self, rec: Record) -> list:
        """Each sampled iteration against the plain reference, from its
        snapshot:

        * exact: ``check.boards`` boards drawn from the seed replayed
          through the rollout by the reference env and SimpleAgent on the
          program's recorded learner moves and the seeds redrawn from the
          host generator's state -- the features (bit for bit), every
          recorded reward, alive, done, term, valid and draw flag, and the
          final game, env and FSM rows; the recorded seeds too
          (``mismatched_values``);
        * the reference's f32 forward on the recorded features of the whole
          batch against the program's ``value`` (and the bootstrap value
          on the replayed boards; ``value_max_abs``) and ``logp`` at the
          recorded move of a live agent (``logp_max_abs``);
        * the draws: the Gumbel uniforms redrawn from the device
          generator's state in the learner's order; a live agent's recorded
          move that is not the reference's argmax counts
          (``moves_mismatched``) unless the reference's two best scores lie
          within ``check.draw_gap``;
        * the reference's GAE on the program's rewards, values, ``term``
          and bootstrap value against its ``adv`` and ``ret``
          (``gae_max_abs``);
        * the reference's update from the snapshot on the program's flat
          batch, the minibatch permutations redrawn after the draws: each
          minibatch's loss (``loss_max_abs``); the parameters after the
          iteration, by the relative L2 of their change, all leaves
          together (``update_rel_l2``), and leaf by leaf by the RMS of
          their difference in units of the learning rate
          (``update_leaf_rms_lr``, the worst leaf: Adam moves every
          element by about ``lr`` a step whatever its gradient's scale, so
          each leaf, the heads' 903 values as the dense kernel's 663,552,
          weighs alike); and the iteration's gradients, by the relative L2
          of the part of Adam's first moment that they make (the moment
          after the iteration less the snapshot's, decayed;
          ``grad_rel_l2``).

          ``leaf_rows`` keeps, for each sampled iteration, each leaf's
          readings (see ``leaf_row``).

        ``check.limits`` holds the limits of the float readings (the
        traffic file gives each one's reason); the exact counts' limit is 0.
        """
        ctx, t = self.ctx, self.t
        lim = t["check"]["limits"]
        items, self.sample = self.sample, None
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        self.leaf_rows = []
        got = [self._check_item(item) for item in items]
        counts = ("mismatched_values", "moves_mismatched")
        worst = {n: (sum if n in counts else max)(g[n] for g in got)
                 for n in got[0]}
        limited = counts + tuple(lim)
        rec.failed = self.steps * sum(
            any(g[n] > lim.get(n, 0) for n in limited) for g in got)
        return [(n, worst[n], lim.get(n, 0)) for n in limited] + [
            ("iterations_checked", len(items), None),
            ("boards_replayed", len(items) * min(t["check"]["boards"],
                                                 self.boards), None),
            ("snapshot_ms", self.snapshot_ms, None)]

    def _check_item(self, item) -> dict:
        cfg, dev = self.cfg, self.ctx.device
        record, snap = item["record"], item["snap"]
        traj = record["traj"]
        names = [n for n, _ in self.leaves]
        like = [p for _, p in self.leaves]
        n_p = len(like)
        leaves = unflatten(snap["flat"], like * (3 if snap["step"] else 1))
        params0 = leaves[:n_p]
        if snap["step"]:
            m0, v0 = leaves[n_p:2 * n_p], leaves[2 * n_p:]
        else:
            m0 = v0 = [torch.zeros_like(p) for p in params0]
        after = unflatten(item["after"], like * 3)
        after, m_after = after[:n_p], after[n_p:2 * n_p]

        host = torch.Generator()
        host.set_state(snap["host_gen"])
        seeds = torch.randint(0, 2 ** 31 - 1, (self.steps,),
                              generator=host).tolist()
        bad = sum(a != b for a, b in zip(seeds, record["seeds"]))
        idx = torch.tensor(board_sample(self.ctx.seed, item["k"], self.boards,
                                        self.t["check"]["boards"]),
                           dtype=torch.int64, device=dev)
        env_bad, boot_err = self._replay(item, seeds, idx, params0)
        out = {"mismatched_values": bad + env_bad}

        t_, b, n_l, feat = traj.feats.shape
        rows = t_ * b * n_l
        block = REF_BLOCK_ROWS
        feats = traj.feats.reshape(rows, feat)
        with torch.no_grad():
            parts = [ref_ppo.forward(params0, feats[s:s + block].float())
                     for s in range(0, rows, block)]
        logits = torch.cat([p[0] for p in parts]).reshape(t_, b, n_l, -1)
        value = torch.cat([p[1] for p in parts]).reshape(t_, b, n_l)
        alive = traj.alive
        logp = torch.log_softmax(logits, -1).gather(
            -1, traj.move.long()[..., None])[..., 0]
        out["value_max_abs"] = max(float((value - traj.value).abs().max()),
                                   boot_err)
        out["logp_max_abs"] = float((logp - traj.logp)[alive].abs().max()) \
            if alive.any() else 0.0

        gen = torch.Generator(device=dev)
        gen.set_state(snap["gen"])
        u = torch.stack([torch.rand((b, n_l, logits.shape[-1]), generator=gen,
                                    device=dev, dtype=torch.float32)
                         for _ in range(t_)])
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        top = (logits - torch.log(-torch.log(u))).topk(2, -1)
        gap = top.values[..., 0] - top.values[..., 1]
        off = (top.indices[..., 0] != traj.move.long()) & alive & \
            (gap > self.t["check"]["draw_gap"])
        out["moves_mismatched"] = int(off.sum())

        adv, ret = ref_ppo.gae(traj.reward, traj.value, traj.term,
                               record["boot_value"], cfg.gamma, cfg.lam)
        out["gae_max_abs"] = max(float((adv - record["adv"]).abs().max()),
                                 float((ret - record["ret"]).abs().max()))

        perms = [torch.randperm(rows, generator=gen, device=dev)
                 if cfg.shuffle_minibatches else None
                 for _ in range(cfg.epochs)]
        mask = traj.alive & traj.valid[:, :, None]
        flat = (feats, traj.move.reshape(rows), traj.logp.reshape(rows),
                record["adv"].reshape(rows), record["ret"].reshape(rows),
                mask.reshape(rows))
        params1, m1, _, step1, losses = ref_ppo.update(
            params0, m0, v0, snap["step"], flat, perms, cfg.minibatches,
            cfg.lr, cfg.clip_eps, cfg.value_coef, cfg.entropy_coef,
            cfg.max_grad_norm)
        out["loss_max_abs"] = max(abs(float(a) - float(b_))
                                  for a, b_ in zip(losses, record["losses"]))
        out["update_rel_l2"] = rel_l2(after, params1, params0)
        decay = ref_ppo.ADAM_B1 ** (step1 - snap["step"])
        m_part = [decay * m for m in m0]
        out["grad_rel_l2"] = rel_l2(m_after, m1, m_part)
        rows_ = [leaf_row(n, *leaf, cfg.lr) for n, leaf in zip(
            names, zip(after, params1, params0, m_after, m1, m_part))]
        self.leaf_rows.append(rows_)
        out["update_leaf_rms_lr"] = max(r["diff_rms_lr"] for r in rows_)
        return out

    def _replay(self, item, seeds, idx, params0):
        """The env replay of ``_check_item`` -> ``(mismatched values, the
        bootstrap value's largest error on the replayed boards)``."""
        cfg, dev = self.cfg, self.ctx.device
        record = item["record"]
        traj = record["traj"]
        slots = tuple(cfg.learner_slots)
        sl = torch.tensor(slots, dtype=torch.int64, device=dev)
        n = idx.shape[0]

        def rows(x):
            return x.index_select(0, idx)

        es, opp = item["es"], item["opp"]
        e = ref_env.EnvState(rules.CellState(*map(rows, es.game)),
                             *map(rows, es[1:]))
        fsm = FsmState(*map(rows, opp))
        agents = torch.arange(rules.AGENT_COUNT, device=dev)
        bad = 0
        for t in range(self.steps):
            feats = ref_ppo.ego_features(e.game, slots, cfg.view_range)
            bad += _ne(_bits(feats.reshape(n, len(slots), -1).to(BF16)),
                       _bits(rows(traj.feats[t])))
            alive_before = ~e.game.agent_dead
            mv = torch.zeros((n, rules.AGENT_COUNT), dtype=torch.int32,
                             device=dev).index_copy(1, sl, rows(traj.move[t]))
            mv = torch.where(e.game.agent_dead, 0, mv)
            e2, fsm2 = ref_env.mixed_step(
                e, mv, fsm, slots,
                torch.full((n,), seeds[t], dtype=torch.int64, device=dev),
                idx, cfg.max_episode_steps)
            fsm = _fresh_fsm(fsm2, e.done)
            died = alive_before & ~e.done[:, None] & e2.game.agent_dead
            ended = e2.done & ~e.done
            won = ended[:, None] & (agents == e2.winner[:, None]) & alive_before
            want = {
                "reward": (won.float() - died.float()).index_select(1, sl),
                "alive": alive_before.index_select(1, sl),
                "done": ended,
                "term": (ended[:, None] | died).index_select(1, sl),
                "draw": ended & (e2.winner < 0),
                "valid": ~e.done,
            }
            bad += sum(_ne(w, rows(getattr(traj, f)[t]))
                       for f, w in want.items())
            e = e2
        final = _flat(item["es2"], item["opp2"])
        bad += sum(_ne(w, rows(g)) for w, g in zip(_flat(e, fsm), final))
        with torch.no_grad():
            _, boot = ref_ppo.forward(params0, ref_ppo.ego_features(
                e.game, slots, cfg.view_range).reshape(n * len(slots), -1))
        boot_err = float((boot.reshape(n, -1)
                          - rows(record["boot_value"])).abs().max())
        return bad, boot_err

"""What the serving drivers share: the port's scheduler over its fused
engine, stepped by the benchmark with a span around every
``Scheduler.step``, the per-request and per-step records the readers
use, and the comparison that decides ``correct``.

The program under test is ``repro_torch.serving.Scheduler`` over
``Engine`` with the configuration's and the cell's ``ServeConfig``
settings.  The benchmark offers each request with its due time, stamps
every token when the step that emitted it returns, and reads the
engine's counters (``Engine.stats``) and trace records (each MoE layer's
expert counts) around each step.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import harness, weights
from .reference import lm as reference

STAT_KEYS = ("iterations", "host_syncs", "prefill_chunks", "prefill_tokens",
             "tokens_emitted", "expert_loads")


@dataclass
class Req:
    """One request as the benchmark saw it (perf_counter seconds)."""
    index: int
    due: float
    prompt: List[int]
    max_new: int
    offered: float = 0.0
    rid: Optional[str] = None           # the scheduler's, None if refused
    arrival: Optional[float] = None     # the scheduler's ticket stamps
    admitted: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    token_t: List[float] = field(default_factory=list)
    done_t: Optional[float] = None


@dataclass
class Step:
    t0: float
    t1: float
    stats: Dict[str, int]               # the engine's counters' deltas
    records: list                       # (layer, phase, counts) a MoE call
    decode_ctx: List[int]               # keys each decode token attended
    first_tokens: int                   # tokens emitted from a prefill


class Server:
    """The program under test, stepped by the benchmark."""

    def __init__(self, ctx: harness.Context):
        import torch
        from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                         ServeConfig)
        self.ctx = ctx
        self.torch = torch
        serve = dict(ctx.conf.get("serve", {}))
        serve.update(ctx.cell.get("serve", {}))
        queue_capacity = int(serve.pop("queue_capacity", 4096))
        weights.layout(ctx.model_cfg)
        ctx.stamp("imported")
        self.params = weights.draw(ctx.model_cfg, ctx.seed, ctx.device)
        self.sync()
        ctx.stamp("weights")
        self.engine = Engine(self.params, ctx.model_cfg, ServeConfig(**serve),
                             device=ctx.device)
        ctx.check("expert_weight_bits",
                  harness.weight_bits(ctx.model_cfg, self.engine.scfg.spec),
                  harness.stated_bits(ctx.conf), bad_when="below")
        self.sched = Scheduler(self.engine,
                               SchedulerConfig(queue_capacity=queue_capacity),
                               clock=time.perf_counter)
        self.reqs: Dict[str, Req] = {}
        self.live: Dict[str, Req] = {}

    def sync(self) -> None:
        if self.ctx.device.type == "cuda":
            self.torch.cuda.synchronize()

    # -- requests ----------------------------------------------------------
    def offer(self, req: Req) -> Optional[str]:
        t = harness.now()
        self.sched.now = t - self.sched._t0
        with self.torch.profiler.record_function("portbench.offer"):
            rid = self.sched.offer(req.prompt, req.max_new,
                                   arrival=req.due - self.sched._t0)
        req.offered = harness.now()
        req.rid = rid
        if rid is not None:
            self.reqs[rid] = req
            self.live[rid] = req
        return rid

    def pending(self) -> int:
        return self.sched.pending()

    # -- one iteration -------------------------------------------------------
    def step(self) -> Step:
        eng = self.engine
        before = {k: int(eng.stats[k]) for k in STAT_KEYS}
        n_trace = len(eng.trace)
        t0 = harness.now()
        with self.torch.profiler.record_function("portbench.scheduler.step"):
            events = self.sched.step()
        t1 = harness.now()
        decode_ctx, first = [], 0
        for rid, tok in events:
            r = self.reqs.get(rid)
            if r is None:
                continue
            if r.token_t:
                # a decode token attends over the prompt, the tokens
                # before it and itself (a request's first token and its
                # second can come from one iteration)
                decode_ctx.append(len(r.prompt) + len(r.token_t))
            else:
                first += 1
            r.tokens.append(int(tok))
            r.token_t.append(t1)
        for rid in list(self.live):
            if self.sched.tickets[rid].done:
                self.live.pop(rid).done_t = t1
        records = [(rec["layer"], rec.get("phase"), np.asarray(rec["counts"]))
                   for rec in eng.trace[n_trace:] if "counts" in rec]
        st = Step(t0, t1, {k: int(eng.stats[k]) - before[k]
                           for k in STAT_KEYS}, records, decode_ctx, first)
        self.ctx.steps.append(st)
        return st

    def counters(self) -> dict:
        from repro_torch.kernels import streamed_moe as sm
        out = {k: int(v) for k, v in self.engine.stats.items()
               if isinstance(v, (int, np.integer))}
        out["graph_captures"] = sum(ms.captures
                                    for ms in self.engine._megasteps.values())
        out["streamed_moe_graph_launches"] = self.engine.graph_launches()
        out["streamed_moe_eager_launches"] = int(sm.LAUNCHES)
        return out

    # -- after the window ----------------------------------------------------
    def finish(self) -> None:
        """Read the peak memory, then free the program's state."""
        torch = self.torch
        self.sync()
        t0 = self.sched._t0
        for rid, req in self.reqs.items():
            ticket = self.sched.tickets[rid]
            req.arrival = ticket.arrival + t0
            if ticket.admitted_at is not None:
                req.admitted = ticket.admitted_at + t0
        if self.ctx.device.type == "cuda":
            self.ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        del self.sched, self.engine, self.params
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def sample_finished(ctx: harness.Context, reqs: List[Req],
                    min_tokens: int) -> List[Req]:
    """The finished request that served the most tokens, then others in
    an order drawn from the seed, until ``min_tokens`` served tokens are
    in the sample (or every finished request is)."""
    done = sorted((r for r in reqs if r.done_t is not None),
                  key=lambda r: r.index)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), -r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(ctx.seed) & (2 ** 64 - 1), 7]))
    out, n = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if n >= min_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def check_served(ctx: harness.Context, sample: List[Req],
                 judged: Optional[List[List[int]]] = None) -> bool:
    """``correct`` for a serving cell: the reference runs once over each
    sampled prompt with its served tokens, and the mean gap by which a
    served token's logit lies below the reference's best must stay under
    the cell's limit, and every other check of the run hold.  (The
    widest gap is recorded beside it: routing flips of the bf16 program
    make it swing as widely as the fp8 control's, so it separates
    nothing; the mean does.)  ``judged``: other tokens to judge at the
    same positions (a control's), in place of the served ones."""
    import torch
    if not sample:
        ctx.extra["served_tokens_compared"] = 0
        return False
    t0 = harness.now()
    w = weights.draw(ctx.model_cfg, ctx.seed, ctx.device)
    with torch.no_grad():
        z = reference.served_logits(w, ctx.conf, [r.prompt for r in sample],
                                    [r.tokens for r in sample])
        gaps = torch.cat([reference.gaps(zi, t) for zi, t in zip(
            z, judged or [r.tokens for r in sample])]).float()
    del w, z
    ctx.extra.update(reference_s=harness.now() - t0,
                     served_tokens_compared=int(gaps.numel()),
                     max_logit_gap=float(gaps.max()),
                     share_off_reference_argmax=float((gaps > 0).float()
                                                      .mean()))
    ctx.check("mean_logit_gap", float(gaps.mean()),
              ctx.cell["check"]["limits"]["mean_logit_gap"])
    return all(c["ok"] for c in ctx.checks.values())

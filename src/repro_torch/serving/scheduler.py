"""Continuous-batching admission scheduler and serving metrics (port of
``repro.serving.scheduler``).

Requests arrive continuously, wait in a bounded admission queue and are
admitted into engine slots the moment one frees; prefill runs in
fixed-token chunks piggybacked on the decode batch
(``Engine.submit_chunked``), so a long prompt never blocks an iteration.

Queue policies: ``fcfs`` (strict FIFO) and ``spf`` (shortest prompt
first, with an aging guard: once the queue head has waited
``starvation_limit`` iterations it is admitted next).  Every generated
token is returned by :meth:`Scheduler.step` and passed to the optional
``on_token`` callback the moment its iteration completes.

Metrics, aggregated into p50/p95/p99 by :class:`ServingMetrics`: TTFT
(arrival to first token), TPOT (mean gap after the first token) and queue
delay (arrival to admission).  The primary clock is the iteration count
(``clock=None``), a callable such as ``time.monotonic`` (wall seconds),
or ``"modeled"``: each step advances by the engine's
``last_step_modeled_s``, the chiplet array's modeled seconds.  A
secondary modeled clock always runs beside it, so the ``*_modeled``
metrics are always reported.

Under queue pressure (``ServeConfig.preempt_queue_depth``) one running
request per step is evicted to the state pool (``Engine.preempt``), and
preempted requests are restored, oldest first, into the slots left once
the queue drains; a request's tokens do not change.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import tracing
from .engine import Engine, QueueFullError


@dataclass
class SchedulerConfig:
    queue_capacity: int = 64
    policy: str = "fcfs"            # fcfs | spf (shortest-prompt-first)
    starvation_limit: int = 32      # spf aging: head admitted after N iters

    def __post_init__(self):
        if self.policy not in ("fcfs", "spf"):
            raise ValueError(f"unknown queue policy {self.policy!r} "
                             f"(want 'fcfs' or 'spf')")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")


@dataclass
class Ticket:
    """One request's lifecycle through queue -> engine -> completion."""
    rid: str
    prompt: List[int]
    max_new: int
    arrival: float
    arrival_iter: int
    engine_rid: Optional[str] = None
    admitted_at: Optional[float] = None
    admitted_iter: Optional[int] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    # the same lifecycle on the secondary modeled clock (chiplet-array
    # seconds integrated from the engine's per-iteration cost model)
    arrival_m: float = 0.0
    admitted_m: Optional[float] = None
    first_token_m: Optional[float] = None
    finished_m: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None


def percentiles(values, qs=(50, 95, 99)) -> Dict[str, float]:
    if not values:
        return {f"p{q}": float("nan") for q in qs}
    arr = np.asarray(values, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


@dataclass
class ServingMetrics:
    """Aggregated per-request latency metrics in clock units."""
    ttft: Dict[str, float]
    tpot: Dict[str, float]
    queue_delay: Dict[str, float]
    completed: int
    rejected: int
    tokens_emitted: int
    elapsed: float
    iterations: int
    # secondary modeled clock (machine-independent chiplet-array
    # seconds) — always present when the engine has a cost model
    ttft_modeled: Dict[str, float] = field(default_factory=dict)
    tpot_modeled: Dict[str, float] = field(default_factory=dict)
    queue_delay_modeled: Dict[str, float] = field(default_factory=dict)
    elapsed_modeled: float = 0.0
    # state-pool activity, mirrored from Engine.stats
    preemptions: int = 0
    restores: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    prefill_tokens_saved: int = 0

    @property
    def throughput(self) -> float:
        return self.tokens_emitted / max(self.elapsed, 1e-12)

    @property
    def throughput_modeled(self) -> float:
        return self.tokens_emitted / max(self.elapsed_modeled, 1e-12)

    def to_dict(self) -> dict:
        return {
            "ttft": self.ttft, "tpot": self.tpot,
            "queue_delay": self.queue_delay,
            "completed": self.completed, "rejected": self.rejected,
            "tokens_emitted": self.tokens_emitted,
            "elapsed": self.elapsed, "iterations": self.iterations,
            "throughput": self.throughput,
            "ttft_modeled": self.ttft_modeled,
            "tpot_modeled": self.tpot_modeled,
            "queue_delay_modeled": self.queue_delay_modeled,
            "elapsed_modeled": self.elapsed_modeled,
            "throughput_modeled": self.throughput_modeled,
            "preemptions": self.preemptions, "restores": self.restores,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "prefill_tokens_saved": self.prefill_tokens_saved,
        }


class Scheduler:
    """Bounded-queue continuous-batching front end over one Engine."""

    def __init__(self, engine: Engine, cfg: Optional[SchedulerConfig] = None,
                 on_token: Optional[Callable[[str, int], None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self.on_token = on_token
        # None -> iteration-counted metric clock (deterministic; each
        # step advances by dt).  A callable (e.g. time.monotonic) makes
        # every metric wall-clocked; "modeled" advances by the engine's
        # last_step_modeled_s (machine-independent modeled seconds).
        if isinstance(clock, str) and clock != "modeled":
            raise ValueError(f"unknown clock {clock!r} "
                             f"(want None, a callable, or 'modeled')")
        self.clock = clock
        self._t0 = clock() if callable(clock) else 0.0
        # secondary modeled clock: always integrates the engine's
        # per-iteration modeled seconds, whatever the primary clock
        self.modeled_now = 0.0
        self.queue: Deque[Ticket] = deque()
        self.tickets: Dict[str, Ticket] = {}        # by scheduler rid
        self._by_engine: Dict[str, Ticket] = {}     # engine rid -> ticket
        # preemption handles (Engine.preempt), restored oldest first
        self._preempted: Deque = deque()
        self._rid = itertools.count()
        self.now = 0.0
        self.iteration = 0
        self.rejected = 0

    # ------------------------------------------------------------------
    # arrivals
    # ------------------------------------------------------------------

    def offer(self, prompt: List[int], max_new: int,
              arrival: Optional[float] = None) -> Optional[str]:
        """Enqueue a request; returns its rid, or None when the bounded
        queue is full (the caller sees backpressure, never an error from
        deep inside the engine).

        ``arrival`` is the request's true arrival timestamp when the
        caller knows it (the traffic loop only polls between engine
        steps, so stamping at offer time would silently exclude up to
        one iteration of queueing from TTFT/queue-delay); default: now.
        """
        if len(self.queue) >= self.cfg.queue_capacity:
            self.rejected += 1
            return None
        # surface bad requests at the door, before they occupy a slot
        self.engine._validate_request(list(prompt), max_new)
        t = Ticket(rid=f"t{next(self._rid)}", prompt=list(prompt),
                   max_new=max_new,
                   arrival=self.now if arrival is None else min(arrival,
                                                                self.now),
                   arrival_iter=self.iteration,
                   arrival_m=self.modeled_now)
        self.queue.append(t)
        self.tickets[t.rid] = t
        return t.rid

    def queue_depth(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _pick(self) -> Ticket:
        if self.cfg.policy == "spf":
            head = self.queue[0]
            if self.iteration - head.arrival_iter < self.cfg.starvation_limit:
                # shortest prompt; FIFO among equals (stable argmin)
                best = min(range(len(self.queue)),
                           key=lambda i: (len(self.queue[i].prompt), i))
                t = self.queue[best]
                del self.queue[best]
                return t
            # aging guard: the head has waited long enough — FIFO pick
        return self.queue.popleft()

    def admit_ready(self) -> List[str]:
        """Fill free engine slots from the queue; returns admitted rids.

        Queued arrivals take freed slots first (what a preemption bought);
        preempted requests are restored, oldest first, into the slots
        left once the queue drains.  A slot lost to a concurrent direct
        ``submit`` surfaces as :class:`QueueFullError`, which requeues the
        ticket instead of crashing the serving loop."""
        admitted = []
        while self.engine.free_slots and self.queue:
            t = self._pick()
            try:
                t.engine_rid = self.engine.submit_chunked(t.prompt,
                                                          t.max_new)
            except QueueFullError:
                self.queue.appendleft(t)
                break
            t.admitted_at = self.now
            t.admitted_iter = self.iteration
            t.admitted_m = self.modeled_now
            self._by_engine[t.engine_rid] = t
            admitted.append(t.rid)
        while self.engine.free_slots and self._preempted:
            self.engine.restore(self._preempted.popleft())
        return admitted

    def _maybe_preempt(self) -> None:
        """When the queue is deeper than ``preempt_queue_depth`` and no
        slot is free, evict one victim to the state pool: the request
        with the most work left, at an iteration boundary, preempted
        fewer than twice (the cap prevents thrash)."""
        bound = self.engine.scfg.preempt_queue_depth
        if bound is None or len(self.queue) <= bound \
                or self.engine.free_slots:
            return
        victims = [r for r in self.engine.requests.values()
                   if not r.done and r.progress == 0 and r.preemptions < 2]
        if not victims:
            return
        v = max(victims,
                key=lambda r: (r.max_new - len(r.generated))
                + (len(r.prompt) - r.prefill_pos))
        self._preempted.append(self.engine.preempt(v.rid))

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def step(self, dt: float = 1.0) -> List[Tuple[str, int]]:
        """One scheduler iteration: admit, run one engine step, emit.

        ``dt`` advances the metric clock (wall seconds in real serving;
        the default 1.0 makes all latency metrics iteration-counted and
        fully deterministic).  Returns (rid, token) pairs in scheduler
        rids."""
        self.iteration += 1
        with tracing.span("repro_torch.scheduler.admit"):
            self._maybe_preempt()
            self.admit_ready()
        events = self.engine.step()
        adv = getattr(self.engine, "last_step_modeled_s", 0.0)
        self.modeled_now += adv
        if callable(self.clock):
            self.now = self.clock() - self._t0
        elif self.clock == "modeled":
            # fall back to dt for iterations the model cannot see (no
            # MoE work, e.g. a pure-attention span) so the clock — and
            # the traffic loop feeding it — always advances
            self.now += adv if adv > 0 else dt
        else:
            self.now += dt
        out: List[Tuple[str, int]] = []
        for erid, tok in events:
            t = self._by_engine.get(erid)
            if t is None:
                continue                      # directly-submitted request
            if t.first_token_at is None:
                t.first_token_at = self.now
                t.first_token_m = self.modeled_now
            t.tokens.append(tok)
            out.append((t.rid, tok))
            if self.on_token is not None:
                self.on_token(t.rid, tok)
        # prune finished tickets from the per-step scan (they stay in
        # self.tickets for outputs()/metrics()) so a long-running server
        # does O(active) work per iteration, not O(all-time requests)
        for erid, t in list(self._by_engine.items()):
            st = self.engine.requests.get(erid)
            if st is not None and st.done and not t.done:
                t.finished_at = self.now
                t.finished_m = self.modeled_now
                del self._by_engine[erid]
        return out

    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return len(self.queue) + sum(
            1 for t in self._by_engine.values() if not t.done)

    def drain(self, max_iterations: int = 100_000, dt: float = 1.0) -> None:
        """Run until every offered request completes."""
        for _ in range(max_iterations):
            if not self.pending():
                return
            self.step(dt)
        raise RuntimeError(f"drain did not converge within {max_iterations} "
                           f"iterations ({self.pending()} pending)")

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def outputs(self) -> Dict[str, List[int]]:
        return {t.rid: list(t.tokens) for t in self.tickets.values()
                if t.engine_rid is not None}

    def metrics(self) -> ServingMetrics:
        done = [t for t in self.tickets.values() if t.done]
        ttft = [t.first_token_at - t.arrival for t in done
                if t.first_token_at is not None]
        qdel = [t.admitted_at - t.arrival for t in done
                if t.admitted_at is not None]
        tpot = [(t.finished_at - t.first_token_at) / (len(t.tokens) - 1)
                for t in done
                if t.first_token_at is not None and len(t.tokens) > 1]
        ttft_m = [t.first_token_m - t.arrival_m for t in done
                  if t.first_token_m is not None]
        qdel_m = [t.admitted_m - t.arrival_m for t in done
                  if t.admitted_m is not None]
        tpot_m = [(t.finished_m - t.first_token_m) / (len(t.tokens) - 1)
                  for t in done
                  if t.first_token_m is not None and len(t.tokens) > 1]
        est = self.engine.stats
        return ServingMetrics(
            ttft=percentiles(ttft), tpot=percentiles(tpot),
            queue_delay=percentiles(qdel), completed=len(done),
            rejected=self.rejected,
            tokens_emitted=sum(len(t.tokens) for t in self.tickets.values()),
            elapsed=self.now, iterations=self.iteration,
            ttft_modeled=percentiles(ttft_m), tpot_modeled=percentiles(tpot_m),
            queue_delay_modeled=percentiles(qdel_m),
            elapsed_modeled=self.modeled_now,
            preemptions=int(est["preemptions"]), restores=int(est["restores"]),
            cache_hits=int(est["cache_hits"]),
            cache_misses=int(est["cache_misses"]),
            prefill_tokens_saved=int(est["prefill_tokens_saved"]))

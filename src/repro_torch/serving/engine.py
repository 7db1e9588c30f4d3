"""Layer-stepped serving engine with QoS token buffering (port of
``repro.serving.engine``).

Each iteration advances every active request by one token, running the
network at MoE-boundary granularity so Algorithm 2 can defer a request
exactly at an MoE boundary: after the layer's gate and before its
experts.  A deferred request keeps its residual stream and resumes from
the same boundary later, so its tokens do not change.  Each MoE layer is
routed once per iteration; the same routing drives deferral, the
workload trace, the per-layer LoadTracker EMA and, under
``schedule="dynamic"``, the expert trajectory.

Two paths share the ``transformer.decode_*`` entry points and give the
same bits:

* **fused** (default) — everything between MoE boundaries runs as one
  segment (``serving.megastep``), on CUDA a captured CUDA graph replayed
  every iteration: a steady decode iteration is ``k + 1`` segments with
  one host sync per MoE boundary (one copy of the counts and routed
  expert ids) and one for the logits, counted in
  ``stats["host_syncs"]``;
* **eager** (``ServeConfig(fused=False)``) — the per-layer Python loop,
  kept as the referee.

Admission is the one-shot ``submit`` (the prompt prefilled at batch 1 and
scattered into the slot's pages) or ``submit_chunked`` (no compute at
admission: each iteration's prefill stage appends up to ``chunk_tokens``
prompt tokens per prefilling slot in one batched pass, and a prompt that
completes emits its first token and joins the decode batch).  The
prefill counts feed the trace (``phase="prefill"``) and the EMAs like the
decode route stage.

Every trace record carries ``modeled_s``, the closed-form seconds of
that layer's expert flow on the paper's chiplet array
(``core.autotune.ServingCostModel``); their sum over an iteration is
``last_step_modeled_s``, which the scheduler's modeled clock integrates.

Sequence state lives in the paged state pool (``serving.statepool``),
which underpins **prefix caching** (``ServeConfig.prefix_cache``: a
prompt that shares a cached prefix is admitted with its pages attached
and computes only the rest) and **preemption** (:meth:`Engine.preempt` /
:meth:`Engine.restore`, driven by the scheduler under queue pressure):
both leave every token as it was.  Decoding is greedy, or samples at
``ServeConfig.temperature`` from ``ServeConfig.seed``.

Two weight tiers are accounting on top of the same tokens: the EMA-hot
**resident tier** (``ServeConfig.resident_budget_mb``) pins each MoE
layer's hottest experts on the package, so they skip their DDR stream in
the modeled clock (``stats["ddr_bytes_saved"]``, each record's
``resident`` ids); and under the ``hybrid`` strategy each record carries
the layer's fast-tier ``hot`` ids (``ServeConfig.hot_experts`` wide),
repartitioned off the EMA every iteration.  ``sim.modes.replay_trace``
referees both.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import autotune, gating, trajectory
from repro_torch.core.policies import TokenBufferPolicy, paired_load_order
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant
from repro_torch.models import api, transformer
from repro_torch.models import moe as moe_mod
from . import statepool
from .megastep import MegaStep, chunk_last_logits


@dataclass
class ServeConfig:
    """The engine's knobs.  ``n_threshold`` defaults from
    ``buffering_slack``; ``pool_pages=None`` sizes the pool at two full
    contexts per slot, the headroom prefix entries and preemption handles
    live in."""
    max_batch: int = 8
    max_ctx: int = 256
    buffering_slack: float = 0.0
    theta_min: int = 2
    n_threshold: Optional[int] = None
    chunk_tokens: int = 16              # prefill chunk (submit_chunked)
    page_size: int = 8
    pool_pages: Optional[int] = None
    # content-hashed prompt prefixes admitted with their pages attached
    prefix_cache: bool = False
    max_prefix_entries: int = 64
    # when the scheduler's queue is deeper than this and no slot is free,
    # one running request is evicted to the pool per step (None: never)
    preempt_queue_depth: Optional[int] = None
    # a request's tokens must not depend on who shares the batch, so the
    # capacity factor is raised to the drop-free bound (C = T*k); False
    # keeps the config's finite capacity (the paper's EP semantics)
    drop_free: bool = True
    fused: bool = True                  # False: the eager per-layer loop
    spec: Optional[object] = None       # ExecutionSpec, strategy name or dict
    ema_decay: float = 0.8              # LoadTracker decay (dynamic schedule)
    # EMA-hot resident tier: this many MiB of expert weights, split evenly
    # over the MoE layers, pinned on the package (each layer's hottest
    # experts by LoadTracker EMA); they skip their DDR stream in the
    # modeled clock and the trace.  Accounting only; 0 disables it.
    resident_budget_mb: float = 0.0
    # hybrid strategy: fast-tier experts per MoE layer (None: the
    # registry's default_hot, the top quartile), repartitioned every
    # iteration off the EMA and recorded per trace record (``hot``)
    hot_experts: Optional[int] = None
    temperature: float = 0.0            # 0 = greedy
    seed: int = 0

    def __post_init__(self):
        from repro_torch.core.strategy import ExecutionSpec
        sp = ExecutionSpec.coerce(self.spec if self.spec is not None
                                  else "capacity", default="capacity")
        if sp.autotune is None:
            sp = dataclasses.replace(sp, autotune="analytic")
        self.spec = sp.validate()
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.preempt_queue_depth is not None \
                and self.preempt_queue_depth < 0:
            raise ValueError("preempt_queue_depth must be >= 0 (or None "
                             "to disable preemption)")
        if self.resident_budget_mb < 0:
            raise ValueError("resident_budget_mb must be >= 0 "
                             f"(got {self.resident_budget_mb})")


@dataclass
class RequestState:
    rid: str
    slot: int
    prompt_len: int
    max_new: int
    generated: List[int] = field(default_factory=list)
    progress: int = 0                   # sub-layer pointer: 2*layer (+1 = ffn pending)
    done: bool = False
    deferred_iterations: int = 0
    # chunked prefill: a "prefill" row consumes chunk_tokens prompt tokens
    # per iteration, then joins the decode batch with its first token
    phase: str = "decode"
    prompt: List[int] = field(default_factory=list)   # pending prompt tokens
    prefill_pos: int = 0                              # tokens already cached
    # the prompt's hash chain (statepool.hash_chain), with prefix_cache on
    prefix_keys: List[bytes] = field(default_factory=list)
    preemptions: int = 0                # times evicted to the state pool


class QueueFullError(RuntimeError):
    """No free engine slot (the scheduler catches this type to requeue)."""


_DEFER_OFF = 1 << 29


class Engine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, *,
                 device=None):
        assert not cfg.is_encoder_decoder, "engine serves LM-family models"
        self.device = resolve_device(device)
        self.params = params
        if scfg.drop_free and cfg.moe is not None \
                and cfg.moe.capacity_factor < cfg.moe.num_experts:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        self.cfg = cfg
        self.scfg = scfg
        self.p, self.plan = transformer.cached_period_plan(cfg)
        self.L = cfg.num_layers
        pages_per_slot = -(-scfg.max_ctx // scfg.page_size)
        num_pages = (scfg.pool_pages if scfg.pool_pages is not None
                     else 2 * scfg.max_batch * pages_per_slot)
        self.caches = transformer.init_paged_caches(
            cfg, scfg.max_batch, num_pages, scfg.page_size, self.device)
        page_b, _ = statepool.state_bytes(self.caches)
        self.pool = statepool.StatePool(
            max_batch=scfg.max_batch, max_ctx=scfg.max_ctx,
            page_size=scfg.page_size, num_pages=num_pages,
            max_prefix_entries=scfg.max_prefix_entries, bytes_per_page=page_b)
        self._table_dev = self._dev(self.pool.table)
        self.cache_len = np.zeros((scfg.max_batch,), np.int64)
        self.requests: Dict[str, RequestState] = {}
        self.free_slots = deque(range(scfg.max_batch))
        self.policy = TokenBufferPolicy.from_slack(scfg.buffering_slack,
                                                   theta_min=scfg.theta_min)
        if scfg.n_threshold is not None:
            self.policy.n_threshold = scfg.n_threshold
        self._x = torch.zeros((scfg.max_batch, 1, cfg.d_model),
                              dtype=torch_dtype(cfg.dtype), device=self.device)
        self._rid = itertools.count()
        self._rng = np.random.default_rng(scfg.seed)
        self.iterations = 0
        self.stats = {"deferrals": 0, "expert_loads": 0,
                      "expert_loads_saved": 0, "iterations": 0,
                      "tokens_emitted": 0, "dynamic_schedules": 0,
                      "prefill_chunks": 0, "prefill_tokens": 0,
                      # fused path: boundary fetches, logits fetches and
                      # prefill fetches, each one copy set and one sync
                      "host_syncs": 0, "preemptions": 0, "restores": 0}
        # the pool's counters (pages, cache hits / misses / evictions,
        # prefill tokens saved) live in the same dict
        self.stats.update(self.pool.stats)
        self.pool.stats = self.stats
        self.trace: List[dict] = []
        self.load_trackers: Dict[int, trajectory.LoadTracker] = {}
        self._layer_schedules: Dict[int, trajectory.Schedule] = {}
        self.dynamic_schedule = scfg.spec.schedule == "dynamic"
        # the modeled chiplet clock; the spec's streamed weight format
        # sets the expert bytes it streams
        self.cost_model = (autotune.ServingCostModel.from_config(
            cfg, weight_bytes=quant.weight_bytes(scfg.spec.weight_dtype))
            if cfg.moe is not None else None)
        # the resident tier: the budget split evenly over the MoE layers
        n_moe = sum(1 for l in range(self.L)
                    if self._layer_kind(l)[1] == "moe")
        self._n_resident = 0
        if scfg.resident_budget_mb > 0 and self.cost_model is not None \
                and n_moe:
            per_layer = int(scfg.resident_budget_mb * 2 ** 20) // n_moe
            self._n_resident = int(min(cfg.moe.num_experts,
                                       per_layer // self.cost_model.expert_bytes))
        self.stats["resident_weight_bytes"] = (
            self._n_resident * n_moe * self.cost_model.expert_bytes
            if self.cost_model is not None else 0)
        self.stats["ddr_bytes_saved"] = 0
        # the hybrid strategy's fast tier, repartitioned off the EMA
        self._n_hot = 0
        if cfg.moe is not None and "hybrid" in scfg.spec.strategies_used():
            from repro_torch.core.strategy import default_hot
            self._n_hot = int(scfg.hot_experts
                              if scfg.hot_experts is not None
                              else default_hot(cfg.moe.num_experts))
            self._n_hot = max(1, min(cfg.moe.num_experts, self._n_hot))
        self._last_hot: Dict[int, Tuple[int, ...]] = {}
        self.stats["hybrid_repartitions"] = 0
        self.last_step_modeled_s = 0.0
        self._iter_modeled_s = 0.0
        # fused segments, one MegaStep per setting read while capturing;
        # on CUDA all their graphs share one memory pool
        self._megasteps: Dict[tuple, MegaStep] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _layer_kind(self, layer: int) -> Tuple[str, str]:
        return self.plan[layer % self.p]

    def megastep(self) -> MegaStep:
        """The fused segments for the current setting: keyed on what the
        segments read when they are captured (the kernels switch, the
        ambient weight dtype, dispatch and autotune level; the spec and
        geometry are the engine's), so a graph captured under one setting
        never replays under another.  (The spec's own autotune level,
        which ``ServeConfig`` always sets, is entered around each MoE
        layer and so rules inside the segments.)"""
        key = (kops.kernels_enabled(), quant.weight_dtype(),
               moe_mod.sorted_dispatch_enabled(), autotune.autotune_level())
        ms = self._megasteps.get(key)
        if ms is None:
            ms = self._megasteps[key] = MegaStep(
                self.params, self.cfg, self.scfg.spec, self.caches, self._x,
                max_batch=self.scfg.max_batch,
                chunk_tokens=self.scfg.chunk_tokens,
                table_cols=self.pool.table.shape[1], pool=self._graph_pool)
        return ms

    def graph_launches(self) -> int:
        """``streamed_moe`` launches made by graph replays, all settings."""
        return sum(ms.launches() for ms in self._megasteps.values())

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _validate_request(self, prompt: List[int], max_new: int) -> None:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.scfg.max_ctx:
            raise ValueError(
                f"request does not fit the context: len(prompt)={len(prompt)}"
                f" + max_new={max_new} > max_ctx={self.scfg.max_ctx}")

    @torch.no_grad()
    def submit(self, prompt: List[int], max_new: int) -> str:
        """One-shot admission: the whole prompt prefilled at batch 1."""
        self._validate_request(prompt, max_new)
        if not self.free_slots:
            raise QueueFullError("engine full — wait for completions")
        slot = self.free_slots.popleft()
        rid = f"req{next(self._rid)}"
        tokens = self._dev(prompt)[None]
        logits, caches1 = api.prefill_fn(self.params, {"tokens": tokens},
                                         self.cfg, self.scfg.max_ctx,
                                         spec=self.scfg.spec)
        self.pool.ensure(slot, len(prompt))
        statepool.merge_prefill(self.caches, caches1,
                                self.pool.slot_pages[slot], self.scfg.page_size)
        self.cache_len[slot] = len(prompt)
        st = RequestState(rid=rid, slot=slot, prompt_len=len(prompt),
                          max_new=max_new)
        st.generated.append(self._sample(self._host(logits[0, -1])))
        self.requests[rid] = st
        return rid

    def submit_chunked(self, prompt: List[int], max_new: int) -> str:
        """Chunked admission: no compute here.  The following ``step``
        calls consume the prompt ``chunk_tokens`` at a time, piggybacked
        on the decode batch; the step that caches the last chunk emits the
        first token.

        With ``prefix_cache`` on, the longest cached prefix of the prompt
        is attached instead of computed (full pages shared, a partial
        tail page copied now, eagerly) and prefill resumes after it: the
        same bits as a cold run, since a token's prefill output does not
        depend on how the prompt was cut into chunks under drop-free
        capacity."""
        self._validate_request(prompt, max_new)
        if not self.free_slots:
            raise QueueFullError("engine full — wait for completions")
        slot = self.free_slots.popleft()
        rid = f"req{next(self._rid)}"
        self.cache_len[slot] = 0
        st = RequestState(rid=rid, slot=slot, prompt_len=len(prompt),
                          max_new=max_new, phase="prefill",
                          prompt=list(prompt))
        if self.scfg.prefix_cache:
            st.prefix_keys = statepool.hash_chain(prompt)
            # one prompt token must run for the first token's logits
            hit = self.pool.lookup_prefix(st.prefix_keys, len(prompt) - 1)
            if hit is not None:
                try:
                    copy = self.pool.attach_prefix(hit, slot)
                except statepool.PoolExhausted:
                    hit = None
            if hit is not None:
                if copy is not None:
                    statepool.copy_page(self.caches, *copy)
                self.cache_len[slot] = hit.length
                st.prefill_pos = hit.length
                self._record_event("cache_hit", rid=rid, slot=slot,
                                   cached_tokens=hit.length)
            else:
                self.stats["cache_misses"] += 1
        self.requests[rid] = st
        return rid

    @staticmethod
    def _host(logits) -> np.ndarray:
        return logits.float().cpu().numpy()

    def _sample(self, lf: np.ndarray) -> int:
        """Greedy at temperature 0, else a draw from the softmax of the
        fp32 logits at ``temperature``, by the reference's numpy draw."""
        lf = np.asarray(lf, np.float32)
        if self.scfg.temperature <= 0:
            return int(lf.argmax())
        p = np.exp((lf - lf.max()) / self.scfg.temperature)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # ------------------------------------------------------------------
    # one forward iteration (all active requests advance <= 1 token)
    # ------------------------------------------------------------------

    def active(self) -> List[RequestState]:
        return [r for r in self.requests.values() if not r.done]

    def prefilling(self) -> List[RequestState]:
        return [r for r in self.requests.values()
                if not r.done and r.phase == "prefill"]

    def _ema_top(self, layer: int, n: int) -> List[int]:
        """The layer's ``n`` hottest experts by LoadTracker EMA (ties to
        the lower id), sorted; the identity prefix before any traffic."""
        tracker = self.load_trackers.get(layer)
        if tracker is None or tracker.steps == 0:
            return list(range(n))
        ema = np.asarray(tracker.ema, np.float64)
        hot = sorted(range(len(ema)), key=lambda e: (-ema[e], e))
        return sorted(hot[:n])

    def _resident_for(self, layer: int) -> List[int]:
        """The layer's resident expert set (``_n_resident`` wide)."""
        return self._ema_top(layer, self._n_resident)

    def _hot_for(self, layer: int) -> List[int]:
        """The layer's hybrid fast-tier expert set (``_n_hot`` wide)."""
        return self._ema_top(layer, self._n_hot)

    def _record(self, rec: dict) -> None:
        """Append a trace record stamped with its modeled seconds.  With
        the resident tier on it carries the layer's ``resident`` ids,
        whose experts skip a stream they would have made (every one under
        a static plan, those with tokens under a dynamic one) and accrue
        ``stats["ddr_bytes_saved"]``; under ``hybrid`` it carries the
        fast-tier ``hot`` ids, which the clock prices on a two-tier
        profile."""
        resident_n = 0
        if self._n_resident and "layer" in rec:
            resident = self._resident_for(rec["layer"])
            rec["resident"] = resident
            if rec["schedule"] == "dynamic":
                counts = rec["counts"]
                resident_n = sum(1 for e in resident if counts[int(e)] > 0)
            else:
                resident_n = len(resident)
            self.stats["ddr_bytes_saved"] += (resident_n
                                              * self.cost_model.expert_bytes)
        hot = None
        if self._n_hot and "layer" in rec:
            hot = self._hot_for(rec["layer"])
            rec["hot"] = hot
            prev = self._last_hot.get(rec["layer"])
            if prev is not None and prev != tuple(hot):
                self.stats["hybrid_repartitions"] += 1
            self._last_hot[rec["layer"]] = tuple(hot)
        if self.cost_model is not None:
            rec["modeled_s"] = self.cost_model.layer_s(
                rec["counts"], dynamic=rec["schedule"] == "dynamic",
                resident=resident_n, hot=hot)
            self._iter_modeled_s += rec["modeled_s"]
        self.trace.append(rec)

    def _record_event(self, event: str, **fields) -> None:
        """Append an event record (``cache_hit``, ``preempt``,
        ``restore``): no counts and no modeled seconds, so consumers of
        the expert flow skip it."""
        self.trace.append({"iter": self.iterations, "event": event,
                           **fields})

    def _register_prefix(self, r: RequestState) -> None:
        """Cache the slot's pages at this chunk boundary under the prompt
        prefix's hash; a partial tail page is copied now.  Skipped when
        the pool cannot spare the tail page even after LRU eviction."""
        P = r.prefill_pos
        try:
            copy = self.pool.register_prefix(r.prefix_keys[P - 1], P, r.slot)
        except statepool.PoolExhausted:
            return
        if copy is not None:
            statepool.copy_page(self.caches, *copy)

    def _ensure_pages(self) -> None:
        """Pages for every KV write of the coming iteration: one position
        per decode row; a prefill row's chunk, plus one when its prompt
        completes (it joins the decode batch in the same iteration)."""
        K = max(1, self.scfg.chunk_tokens)
        for r in self.active():
            if r.phase == "prefill":
                k_r = min(K, len(r.prompt) - r.prefill_pos)
                length = int(self.cache_len[r.slot]) + k_r
                if r.prefill_pos + k_r >= len(r.prompt):
                    length += 1
            else:
                length = int(self.cache_len[r.slot]) + 1
            self.pool.ensure(r.slot, min(length, self.scfg.max_ctx))
        if not self.scfg.fused:
            self._table_dev = self._dev(self.pool.table)

    def _prefill_chunk_step(self, fused: bool) -> List[Tuple[str, int]]:
        """Advance every prefilling request by one prompt chunk in one
        batched pass (decode and idle slots ride along fully masked); a
        request whose prompt completes samples its first token from its
        last chunk position."""
        pre = self.prefilling()
        if not pre:
            return []
        scfg = self.scfg
        B, K = scfg.max_batch, max(1, scfg.chunk_tokens)
        tokens = np.zeros((B, K), np.int64)
        mask = np.zeros((B, K), bool)
        took: Dict[str, int] = {}
        for r in pre:
            k_r = min(K, len(r.prompt) - r.prefill_pos)
            tokens[r.slot, :k_r] = r.prompt[r.prefill_pos:r.prefill_pos + k_r]
            mask[r.slot, :k_r] = True
            took[r.rid] = k_r
        completes = any(r.prefill_pos + took[r.rid] >= len(r.prompt)
                        for r in pre)
        if fused:
            ms = self.megastep()
            ms.set(cache_len=self.cache_len, table=self.pool.table,
                   tokens=tokens, token_mask=mask)
            ms.prefill()
            self.stats["host_syncs"] += 1
            fetched = ms.fetch(ms.pre_counts, *((ms.pre_logits,)
                                                if completes else ()))
            counts = fetched[0]
            first_logits = fetched[1] if completes else None
        else:
            tmask = torch.as_tensor(mask, device=self.device)
            hid, _, counts = api.prefill_chunk_fn(
                self.params, self._dev(tokens), self.caches,
                self._dev(self.cache_len), self.cfg, spec=scfg.spec,
                token_mask=tmask, return_hidden=True,
                page_table=self._table_dev)
            counts = counts.cpu().numpy().astype(np.int64)
            first_logits = (self._host(chunk_last_logits(self.params, hid,
                                                         tmask))
                            if completes else None)
        for layer in range(self.L):
            if self._layer_kind(layer)[1] != "moe":
                continue
            cnt = counts[layer // self.p, layer % self.p]
            tracker = self.load_trackers.setdefault(
                layer, trajectory.LoadTracker(self.cfg.moe.num_experts,
                                              decay=scfg.ema_decay))
            tracker.update(cnt)
            self._record({
                "iter": self.iterations, "layer": layer, "phase": "prefill",
                "counts": cnt.copy(), "order": paired_load_order(cnt),
                "schedule": "dynamic" if self.dynamic_schedule else "static"})
            self.stats["expert_loads"] += int((cnt > 0).sum())

        out: List[Tuple[str, int]] = []
        for r in pre:
            k_r = took[r.rid]
            self.cache_len[r.slot] += k_r
            r.prefill_pos += k_r
            self.stats["prefill_tokens"] += k_r
            if scfg.prefix_cache and r.prefix_keys:
                self._register_prefix(r)
            if r.prefill_pos < len(r.prompt):
                continue
            first = self._sample(first_logits[r.slot])
            r.generated.append(first)
            r.phase = "decode"
            r.progress = 0
            r.prompt = []
            out.append((r.rid, first))
            self.stats["tokens_emitted"] += 1
            if len(r.generated) >= r.max_new:
                r.done = True
                self.free_slots.append(r.slot)
                self.pool.release_slot(r.slot)
                self.policy.drop(r.rid)
        self.stats["prefill_chunks"] += len(pre)
        return out

    @torch.no_grad()
    def step(self) -> List[Tuple[str, int]]:
        self.last_step_modeled_s = 0.0
        if not self.active():
            return []
        self._iter_modeled_s = 0.0
        self._ensure_pages()
        out = self._step_fused() if self.scfg.fused else self._step_legacy()
        self.last_step_modeled_s = self._iter_modeled_s
        return out

    def _start_masks(self, act):
        """Fresh-token vector and start mask of the rows beginning a pass."""
        B = self.scfg.max_batch
        token_vec = np.zeros((B,), np.int64)
        start_mask = np.zeros((B,), bool)
        for r in act:
            if r.progress == 0:
                token_vec[r.slot] = r.generated[-1]
                start_mask[r.slot] = True
        return token_vec, start_mask

    def _rows(self, rows) -> np.ndarray:
        m = np.zeros((self.scfg.max_batch,), bool)
        m[[r.slot for r in rows]] = True
        return m

    # ------------------------------------------------------------------
    # fused iteration (serving.megastep)
    # ------------------------------------------------------------------

    def _step_fused(self) -> List[Tuple[str, int]]:
        self.iterations += 1
        self.stats["iterations"] += 1
        out = self._prefill_chunk_step(fused=True)
        act = [r for r in self.active() if r.phase == "decode"]
        if not act:
            return out
        ms = self.megastep()
        token_vec, start_mask = self._start_masks(act)
        ms.set(cache_len=self.cache_len, table=self.pool.table,
               token_vec=token_vec, start_mask=start_mask)
        bnds = ms.boundaries
        if not bnds:
            ms.only()
            for r in act:
                if start_mask[r.slot]:
                    r.progress = 2 * self.L
            return self._finish(act, out, lambda: self._fetch_logits(ms))

        b0 = bnds[0]
        for r in act:
            if r.progress == 0:
                r.progress = 2 * b0 + 1
        run_ffn = [r for r in act if not r.done and r.progress == 2 * b0 + 1]
        ms.set(count_mask=self._rows(run_ffn))
        ms.first()
        kept = self._boundary_fused(b0, run_ffn, ms)
        for j, b in enumerate(bnds[1:], start=1):
            for r in kept:
                r.progress = 2 * b + 1
            run_ffn = [r for r in act
                       if not r.done and r.progress == 2 * b + 1]
            ms.set(count_mask=self._rows(run_ffn))
            ms.mid(j)
            kept = self._boundary_fused(b, run_ffn, ms)
        ms.last()
        for r in kept:
            r.progress = 2 * self.L
        return self._finish(act, out, lambda: self._fetch_logits(ms))

    def _boundary_fused(self, layer, run_ffn, ms: MegaStep):
        """Host work at one MoE boundary: one fetch of the counts and
        routed ids, the shared bookkeeping, and the inputs of the segment
        that executes this boundary's experts (rows kept, trajectory).
        Returns the rows kept."""
        kept: List[RequestState] = []
        order = np.arange(ms.E)
        if run_ffn:
            self.stats["host_syncs"] += 1
            (fetched,) = ms.fetch(ms.route_out)
            counts = fetched[:ms.E]
            idx = fetched[ms.E:].reshape(self.scfg.max_batch, -1)
            kept = self._boundary_host(layer, run_ffn, counts, idx,
                                       gating.Routing(*ms.routing))
            if self.dynamic_schedule and kept:
                self.stats["dynamic_schedules"] += 1
                order = self._layer_schedules[layer].order
        ms.set(exec_mask=self._rows(kept), order=order)
        return kept

    def _fetch_logits(self, ms: MegaStep) -> np.ndarray:
        self.stats["host_syncs"] += 1
        (host,) = ms.fetch(ms.logits)
        return host

    def _finish(self, act, out, host_logits):
        """Emit a token for every request that completed the pass;
        ``host_logits()`` brings the (B, 1, V) logits over in one transfer,
        called only when some request finished."""
        finish = [r for r in act if not r.done and r.progress == 2 * self.L]
        if not finish:
            return out
        host = host_logits()
        for r in finish:
            tok = self._sample(host[r.slot, 0])
            r.generated.append(tok)
            out.append((r.rid, tok))
            self.stats["tokens_emitted"] += 1
            r.progress = 0
            self.cache_len[r.slot] += 1
            self.policy.on_forward_pass(r.rid)
            if len(r.generated) >= r.max_new or \
                    int(self.cache_len[r.slot]) >= self.scfg.max_ctx - 1:
                r.done = True
                self.free_slots.append(r.slot)
                self.pool.release_slot(r.slot)
                self.policy.drop(r.rid)
        return out

    # ------------------------------------------------------------------
    # eager per-layer iteration (fused=False)
    # ------------------------------------------------------------------

    def _step_legacy(self) -> List[Tuple[str, int]]:
        self.iterations += 1
        self.stats["iterations"] += 1
        out = self._prefill_chunk_step(fused=False)
        act = [r for r in self.active() if r.phase == "decode"]
        if not act:
            return out
        token_vec, start_mask = self._start_masks(act)
        x = transformer.decode_embed_merge(
            self.params, self._x, self._dev(token_vec),
            torch.as_tensor(start_mask, device=self.device), self.cfg)
        cache_len = self._dev(self.cache_len)
        for layer in range(self.L):
            _, ffn_kind = self._layer_kind(layer)
            run_attn = [r for r in act if not r.done and r.progress == 2 * layer]
            if run_attn:
                x, self.caches = transformer.decode_mixer(
                    self.params, x, self.caches, cache_len, self.cfg, layer,
                    self._mask([r.slot for r in run_attn]),
                    page_table=self._table_dev)
                for r in run_attn:
                    r.progress = 2 * layer + 1
            run_ffn = [r for r in act
                       if not r.done and r.progress == 2 * layer + 1]
            if not run_ffn:
                continue
            if ffn_kind == "moe":
                # route ONCE: the same Routing drives deferral, the trace,
                # the EMA feedback and the expert execution
                h, routing, _ = transformer.decode_route(self.params, x,
                                                         self.cfg, layer)
                run_ffn = self._defer_cold(routing, layer, run_ffn)
                if not run_ffn:
                    continue
                x = self._apply_moe(x, h, routing, [r.slot for r in run_ffn],
                                    layer)
            else:
                x = transformer.decode_ffn(self.params, x, self.cfg, layer,
                                           self._mask([r.slot for r in run_ffn]))
            for r in run_ffn:
                r.progress = 2 * (layer + 1)
        self._x.copy_(x)
        logits = transformer.decode_logits(self.params, x, self.cfg)
        return self._finish(act, out, lambda: self._host(logits))

    # ------------------------------------------------------------------
    # MoE boundary: route stage bookkeeping, deferral, execution
    # ------------------------------------------------------------------

    def _mask(self, slots: List[int]) -> torch.Tensor:
        m = np.zeros((self.scfg.max_batch,), bool)
        m[slots] = True
        return torch.as_tensor(m, device=self.device)

    def _slot_counts(self, routing, slots) -> np.ndarray:
        return gating.expert_token_counts(routing, self._mask(slots)) \
            .cpu().numpy().astype(np.int64)

    def _boundary_host(self, layer, run_ffn, counts, idx, routing):
        """LoadTracker EMA update, trace record (with the EMA trajectory
        when dynamic) and the Algorithm-2 deferral sweep, shared by both
        paths.  Returns the rows that are not deferred."""
        tracker = self.load_trackers.setdefault(
            layer, trajectory.LoadTracker(self.cfg.moe.num_experts,
                                          decay=self.scfg.ema_decay))
        tracker.update(counts)
        rec = {"iter": self.iterations, "layer": layer, "phase": "decode",
               "counts": counts.copy(), "order": paired_load_order(counts),
               "schedule": "dynamic" if self.dynamic_schedule else "static"}
        if self.dynamic_schedule:
            # under hybrid the plan carries the engine's fast-tier width,
            # so the eager path executes the trace's ``hot`` partition
            plan = None
            if self._n_hot:
                plan = autotune.Plan(mode="hybrid", family="hybrid",
                                     micro_slices=1, hot_experts=self._n_hot)
            sched = tracker.schedule(plan=plan)
            self._layer_schedules[layer] = sched
            rec["trajectory"] = list(sched.order)
        self._record(rec)
        self.stats["expert_loads"] += int((counts > 0).sum())
        if self.policy.n_threshold >= _DEFER_OFF:
            return list(run_ffn)
        kept = []
        for r in run_ffn:
            acts = [int(e) for e in idx[r.slot]]
            if self.policy.should_defer(r.rid, acts, counts):
                self.stats["deferrals"] += 1
                r.deferred_iterations += 1
            else:
                kept.append(r)
        if len(kept) != len(run_ffn):
            counts2 = self._slot_counts(routing, [r.slot for r in kept])
            self.stats["expert_loads_saved"] += int((counts > 0).sum()
                                                    - (counts2 > 0).sum())
        return kept

    def _defer_cold(self, routing, layer, run_ffn):
        counts = self._slot_counts(routing, [r.slot for r in run_ffn])
        idx = None
        if self.policy.n_threshold < _DEFER_OFF:
            idx = routing.indices.cpu().numpy()
        return self._boundary_host(layer, run_ffn, counts, idx, routing)

    def _apply_moe(self, x, h, routing, slots, layer):
        schedule = None
        if self.dynamic_schedule:
            schedule = self._layer_schedules[layer]
            self.stats["dynamic_schedules"] += 1
        return transformer.decode_moe_exec(
            self.params, x, h, routing, self.cfg, layer, self._mask(slots),
            spec=self.scfg.spec, schedule=schedule)

    # ------------------------------------------------------------------
    # preemption: evict a request's state to the pool, restore it
    # ------------------------------------------------------------------

    def preempt(self, rid: str) -> statepool.PreemptedState:
        """Evict an active request at an iteration boundary
        (``progress == 0``), freeing its slot: its page references move
        to the handle, nothing on the device moves.  :meth:`restore`
        resumes it with the same bits in any free slot."""
        r = self.requests.get(rid)
        if r is None or r.done:
            raise ValueError(f"no active request {rid!r}")
        if r.progress != 0:
            raise ValueError(
                f"request {rid!r} is mid-pass (progress={r.progress}): its "
                f"deferred hidden state lives in the residual buffer and "
                f"cannot be evicted — pick a victim at progress == 0")
        handle = statepool.PreemptedState(
            request=r, page_ids=self.pool.detach_slot(r.slot),
            cache_len=int(self.cache_len[r.slot]))
        del self.requests[rid]
        self.free_slots.append(r.slot)
        r.preemptions += 1
        self.stats["preemptions"] += 1
        self._record_event("preempt", rid=rid, slot=r.slot,
                           cache_len=handle.cache_len)
        return handle

    def restore(self, handle: statepool.PreemptedState) -> str:
        """Resume a preempted request in a free slot, under its own rid."""
        if not self.free_slots:
            raise QueueFullError("engine full — cannot restore preempted "
                                 "request; wait for completions")
        r = handle.request
        slot = self.free_slots.popleft()
        r.slot = slot
        self.pool.attach_pages(slot, handle.page_ids)
        self.cache_len[slot] = handle.cache_len
        self.requests[r.rid] = r
        self.stats["restores"] += 1
        self._record_event("restore", rid=r.rid, slot=slot,
                           cache_len=handle.cache_len)
        return r.rid

    def run(self, max_iterations: int = 10_000) -> Dict[str, List[int]]:
        for _ in range(max_iterations):
            if not self.active():
                break
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}

"""Layer-stepped serving engine with QoS token buffering (port of
``repro.serving.engine``, the eager per-layer loop).

Each iteration advances every active request by one token, running the
network one layer at a time through the ``decode_*`` entry points so
Algorithm 2 can defer a request exactly at an MoE boundary: after the
layer's gate and before its experts.  A deferred request keeps its
residual stream and resumes from the same boundary later, so its tokens
do not change.  Each MoE layer is routed once per iteration; the same
routing drives deferral, the workload trace, the per-layer LoadTracker
EMA and, under ``schedule="dynamic"``, the expert trajectory.

Admission is the one-shot ``submit``: the prompt is prefilled at batch 1
and scattered into the slot's pages of the paged KV pool.  The
reference's fused mega-step, chunked admission, prefix cache,
preemption, modeled clock and resident/hybrid tiers are later work
(ROADMAP A.7-A.11).  The reference pins its fused path to this eager
loop bit for bit.
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
from repro_torch.core import gating, trajectory
from repro_torch.core.policies import TokenBufferPolicy, paired_load_order
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import api, transformer
from . import statepool


@dataclass
class ServeConfig:
    """The engine's knobs.  Decoding is greedy, the capacity factor is
    always drop-free (C = T*k, so no token is dropped because of who
    shares the batch), the pool holds two full contexts per slot and the
    deferral threshold follows from ``buffering_slack``."""
    max_batch: int = 8
    max_ctx: int = 256
    buffering_slack: float = 0.0
    theta_min: int = 2
    page_size: int = 8
    spec: Optional[object] = None       # ExecutionSpec, strategy name or dict

    def __post_init__(self):
        from repro_torch.core.strategy import ExecutionSpec
        sp = ExecutionSpec.coerce(self.spec if self.spec is not None
                                  else "capacity", default="capacity")
        if sp.autotune is None:
            sp = dataclasses.replace(sp, autotune="analytic")
        self.spec = sp.validate()
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")


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


class QueueFullError(RuntimeError):
    """No free engine slot."""


_DEFER_OFF = 1 << 29


class Engine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, *,
                 device=None):
        assert not cfg.is_encoder_decoder, "engine serves LM-family models"
        self.device = resolve_device(device)
        self.params = params
        if cfg.moe is not None \
                and cfg.moe.capacity_factor < cfg.moe.num_experts:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        self.cfg = cfg
        self.scfg = scfg
        self.p, self.plan = transformer.cached_period_plan(cfg)
        self.L = cfg.num_layers
        pages_per_slot = -(-scfg.max_ctx // scfg.page_size)
        num_pages = 2 * scfg.max_batch * pages_per_slot
        self.caches = transformer.init_paged_caches(
            cfg, scfg.max_batch, num_pages, scfg.page_size, self.device)
        page_b, _ = statepool.state_bytes(self.caches)
        self.pool = statepool.StatePool(
            max_batch=scfg.max_batch, max_ctx=scfg.max_ctx,
            page_size=scfg.page_size, num_pages=num_pages,
            bytes_per_page=page_b)
        self._table_dev = self._dev(self.pool.table)
        self.cache_len = np.zeros((scfg.max_batch,), np.int64)
        self.requests: Dict[str, RequestState] = {}
        self.free_slots = deque(range(scfg.max_batch))
        self.policy = TokenBufferPolicy.from_slack(scfg.buffering_slack,
                                                   theta_min=scfg.theta_min)
        self._x = torch.zeros((scfg.max_batch, 1, cfg.d_model),
                              dtype=torch_dtype(cfg.dtype), device=self.device)
        self._rid = itertools.count()
        self.iterations = 0
        self.stats = {"deferrals": 0, "expert_loads": 0,
                      "expert_loads_saved": 0, "iterations": 0,
                      "tokens_emitted": 0, "dynamic_schedules": 0}
        self.stats.update(self.pool.stats)
        self.pool.stats = self.stats
        self.trace: List[dict] = []
        self.load_trackers: Dict[int, trajectory.LoadTracker] = {}
        self._layer_schedules: Dict[int, trajectory.Schedule] = {}
        self.dynamic_schedule = scfg.spec.schedule == "dynamic"

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _layer_kind(self, layer: int) -> Tuple[str, str]:
        return self.plan[layer % self.p]

    # ------------------------------------------------------------------
    # admission: full-prompt prefill into a slot
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

    @staticmethod
    def _host(logits) -> np.ndarray:
        return logits.float().cpu().numpy()

    def _sample(self, lf: np.ndarray) -> int:
        """Greedy decoding."""
        return int(np.asarray(lf, np.float32).argmax())

    # ------------------------------------------------------------------
    # one forward iteration (all active requests advance <= 1 token)
    # ------------------------------------------------------------------

    def active(self) -> List[RequestState]:
        return [r for r in self.requests.values() if not r.done]

    def _ensure_pages(self) -> None:
        """Pages for every KV write of the coming iteration (one position
        per decode row); the table goes to the device once."""
        for r in self.active():
            self.pool.ensure(r.slot, min(int(self.cache_len[r.slot]) + 1,
                                         self.scfg.max_ctx))
        self._table_dev = self._dev(self.pool.table)

    @torch.no_grad()
    def step(self) -> List[Tuple[str, int]]:
        if not self.active():
            return []
        self._ensure_pages()
        self.iterations += 1
        self.stats["iterations"] += 1
        act = self.active()
        out: List[Tuple[str, int]] = []
        token_vec = np.zeros((self.scfg.max_batch,), np.int64)
        start_mask = np.zeros((self.scfg.max_batch,), bool)
        for r in act:
            if r.progress == 0:
                token_vec[r.slot] = r.generated[-1]
                start_mask[r.slot] = True
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
        self._x = x
        logits = transformer.decode_logits(self.params, x, self.cfg)
        return self._finish(act, logits, out)

    def _finish(self, act, logits, out):
        """Emit a token for every request that completed the pass."""
        finish = [r for r in act if not r.done and r.progress == 2 * self.L]
        if not finish:
            return out
        host = self._host(logits)                  # one transfer per step
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
        when dynamic) and the Algorithm-2 deferral sweep.  Returns the
        rows that are not deferred."""
        tracker = self.load_trackers.setdefault(
            layer, trajectory.LoadTracker(self.cfg.moe.num_experts))
        tracker.update(counts)
        rec = {"iter": self.iterations, "layer": layer, "phase": "decode",
               "counts": counts.copy(), "order": paired_load_order(counts),
               "schedule": "dynamic" if self.dynamic_schedule else "static"}
        if self.dynamic_schedule:
            sched = tracker.schedule()
            self._layer_schedules[layer] = sched
            rec["trajectory"] = list(sched.order)
        self.trace.append(rec)
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

    def run(self, max_iterations: int = 10_000) -> Dict[str, List[int]]:
        for _ in range(max_iterations):
            if not self.active():
                break
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}

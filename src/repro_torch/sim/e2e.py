"""End-to-end multi-iteration simulation, paper §VI-C, Fig. 14/15 (port
of ``repro.sim.e2e``).

Runs N forward iterations of attention + all MoE layers under a
strategy, with optional token buffering (Algorithm 2 via
``core.policies.TokenBufferPolicy``).  A deferred request pauses
at its MoE layer: its remaining-layer tokens are carried into the next
iteration's workloads (re-batched with new tokens — the paper's
re-evaluation of expert-activation patterns), bounded by QoS slack.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.policies import TokenBufferPolicy
from .hardware import HardwareConfig, ModelSpec
from .workload import (LayerWorkload, Request,  # noqa: F401
                       make_layer_workload, make_requests)
from .engine import simulate_layer


@dataclass
class E2EResult:
    total_time: float
    tokens_processed: int
    iterations: int
    throughput: float                  # tokens/s
    mean_utilization: float
    deferral_events: int
    peak_buffer_bytes: int
    per_iteration_latency: List[float] = field(default_factory=list)


def _attention_time(hw: HardwareConfig, spec: ModelSpec, tokens: int,
                    ctx: int = 1024) -> float:
    """Head-parallel attention across chiplets + dense QKVO projections.

    flops = qkvo projections + score/value matmuls against a ``ctx``-long
    KV cache; KV cache streamed from DDR.
    """
    d = spec.d_model
    proj = 4.0 * tokens * d * d * 2
    attn = 2.0 * tokens * ctx * d * 2
    t_compute = (proj + attn) / (hw.num_chiplets * hw.tops)
    kv_bytes = 2.0 * ctx * d * hw.bytes_per_act * max(1, tokens // 16)
    return t_compute + kv_bytes / hw.ddr_total


def run_e2e(hw: HardwareConfig, spec: ModelSpec, *, strategy: str,
            tokens_per_iter: int, iterations: int = 20, seed: int = 0,
            buffering_slack: float = 0.0, theta_min: int = 4,
            layer_sample: Optional[int] = None, ctx: int = 1024) -> E2EResult:
    """layer_sample: simulate this many MoE layers per iteration and scale
    (keeps the benchmark wall-time sane for 48-layer models)."""
    rng = np.random.default_rng(seed)
    policy = TokenBufferPolicy.from_slack(buffering_slack, theta_min=theta_min) \
        if buffering_slack > 0 else None

    n_layers = spec.num_layers
    sample = layer_sample or n_layers
    sample = min(sample, n_layers)
    scale = n_layers / sample

    total_time = 0.0
    tokens_done = 0
    deferrals = 0
    utils: List[float] = []
    peaks: List[int] = []
    per_iter: List[float] = []

    # requests persist across iterations (decode-style: the same mixed
    # prefill/decode request set contributes tokens every forward pass);
    # deferred requests carry their resume layer into the next iteration
    pool = make_requests(tokens_per_iter, hw.num_chiplets, seed * 997)
    if policy is not None:
        for r in pool:
            policy.state(r.rid).timer = 1   # arrival credit (one deferral)
    carry: List[tuple] = []    # (Request, resume_layer_idx)

    for it in range(iterations):
        carried_ids = {r.rid for r, _ in carry}
        active: List[tuple] = [(r, 0) for r in pool if r.rid not in carried_ids] + carry
        carry = []
        iter_time = _attention_time(hw, spec, sum(r.num_tokens for r, _ in active),
                                    ctx=ctx)
        layer_ids = sorted(rng.choice(n_layers, size=sample, replace=False)) \
            if sample < n_layers else list(range(n_layers))

        for li, layer in enumerate(layer_ids):
            live = [(r, s) for (r, s) in active if s <= layer]
            if not live:
                continue
            wl = make_layer_workload(spec, [r for r, _ in live],
                                     hw.num_chiplets, layer, seed * 31 + it)
            if policy is not None:
                totals = wl.expert_totals
                kept: List[Request] = []
                for r, s in live:
                    acts = wl.per_request.get(r.rid, [])
                    if acts and policy.should_defer(r.rid, acts, totals):
                        deferrals += 1
                        carry.append((r, layer))
                        active = [(rr, ss) for (rr, ss) in active if rr.rid != r.rid]
                    else:
                        kept.append(r)
                if len(kept) != len(live):
                    wl = make_layer_workload(spec, kept, hw.num_chiplets,
                                             layer, seed * 31 + it)
                if not kept:
                    continue
            res = simulate_layer(hw, spec, wl, strategy)
            iter_time += res.latency * scale
            utils.append(res.utilization)
            peaks.append(res.peak_buffer_bytes)
        if sample < n_layers:
            # scale the sampled-MoE portion up to the full depth
            moe_part = iter_time - _attention_time(
                hw, spec, sum(r.num_tokens for r, _ in active) or 1, ctx=ctx)
            iter_time += moe_part * (scale - 1.0)

        total_time += iter_time
        per_iter.append(iter_time)
        done_tokens = sum(r.num_tokens for r, s in active)
        tokens_done += done_tokens
        if policy is not None:
            for r, _ in active:
                policy.on_forward_pass(r.rid)

    return E2EResult(
        total_time=total_time, tokens_processed=tokens_done,
        iterations=iterations,
        throughput=tokens_done / max(total_time, 1e-12),
        mean_utilization=float(np.mean(utils)) if utils else 0.0,
        deferral_events=deferrals,
        peak_buffer_bytes=max(peaks) if peaks else 0,
        per_iteration_latency=per_iter)

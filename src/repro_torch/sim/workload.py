"""Long-tail MoE activation workloads, paper §II-B, Fig. 2 (port of
``repro.sim.workload``).

Per-layer expert-activation counts come from a request-mixed
Zipf/Dirichlet model calibrated to the paper's observation: with 16-256
tokens per iteration a handful of experts absorb most tokens while a
non-negligible fraction receive 0-2 tokens, and the skew sharpens as the
token count shrinks.  The traffic generator (``serving.traffic``) draws
its request sizes and Zipf affinities from the same splitter and
sampler, so its streams are the reference's byte for byte; the serving
engine's trace replays into simulator workloads through
:func:`workloads_from_trace`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .hardware import ModelSpec


@dataclass
class LayerWorkload:
    """Expert token counts for one MoE layer in one iteration.

    counts[c][e] — tokens on chiplet ``c`` activating expert ``e``.
    per_request[rid] — list of expert ids activated by request ``rid``.
    """
    counts: np.ndarray                    # (chiplets, E) int
    per_request: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def expert_totals(self) -> np.ndarray:
        return self.counts.sum(axis=0)

    @property
    def total_tokens(self) -> int:
        # each token activates top_k experts; counts are per-activation
        return int(self.counts.sum())


@dataclass
class Request:
    rid: str
    num_tokens: int
    home_chiplet: int
    affinity_seed: int                     # per-request expert affinity


def sample_expert_probs(E: int, rng: np.random.Generator,
                        zipf_s: float = 1.1) -> np.ndarray:
    """Zipf-ranked probabilities with random rank permutation."""
    ranks = np.arange(1, E + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    p /= p.sum()
    return p[rng.permutation(E)]


def route_tokens(E: int, top_k: int, num_tokens: int, probs: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """Counts (E,) of token-activations via top-k draws w/o replacement."""
    counts = np.zeros(E, np.int64)
    for _ in range(num_tokens):
        # Gumbel top-k == sampling w/o replacement by probs
        g = np.log(probs + 1e-12) + rng.gumbel(size=E)
        picks = np.argpartition(-g, top_k)[:top_k]
        counts[picks] += 1
    return counts


def make_layer_workload(spec: ModelSpec, requests: List[Request],
                        num_chiplets: int, layer_idx: int, seed: int,
                        mix: float = 0.5) -> LayerWorkload:
    """Per-request routing = mix·layer-global Zipf + (1-mix)·request affinity."""
    rng = np.random.default_rng(seed * 1000003 + layer_idx)
    global_p = sample_expert_probs(spec.num_experts, rng)
    counts = np.zeros((num_chiplets, spec.num_experts), np.int64)
    per_request: Dict[str, List[int]] = {}
    for req in requests:
        rrng = np.random.default_rng(req.affinity_seed * 7919 + layer_idx)
        local_p = sample_expert_probs(spec.num_experts, rrng)
        p = mix * global_p + (1 - mix) * local_p
        p /= p.sum()
        c = route_tokens(spec.num_experts, spec.top_k, req.num_tokens, p, rng)
        counts[req.home_chiplet] += c
        per_request[req.rid] = [int(e) for e in np.nonzero(c)[0]]
    return LayerWorkload(counts=counts, per_request=per_request)


def make_requests(tokens_per_iter: int, num_chiplets: int, seed: int,
                  avg_request_tokens: int | None = None) -> List[Request]:
    """Split an iteration's token budget into mixed prefill/decode requests."""
    rng = np.random.default_rng(seed)
    if avg_request_tokens is None:
        avg_request_tokens = max(1, tokens_per_iter // 8)
    reqs: List[Request] = []
    remaining = tokens_per_iter
    i = 0
    while remaining > 0:
        n = int(min(remaining, max(1, rng.poisson(avg_request_tokens))))
        reqs.append(Request(rid=f"r{seed}_{i}", num_tokens=n,
                            home_chiplet=i % num_chiplets,
                            affinity_seed=int(rng.integers(1 << 30))))
        remaining -= n
        i += 1
    return reqs


def workload_from_counts(counts, num_chiplets: int,
                         per_request: Dict[str, List[int]] | None = None
                         ) -> LayerWorkload:
    """Engine-observed per-expert totals -> a chiplet-resolved workload.

    The serving engine traces total activations per expert (its tokens
    have no chiplet placement); the simulator wants (chiplets, E).
    Tokens are striped across chiplets round-robin with a per-expert
    rotating offset so the remainder does not always land on chiplet 0.
    Exactness invariant (tested): ``result.expert_totals == counts``.
    """
    counts = np.asarray(counts, np.int64)
    E = counts.shape[0]
    out = np.zeros((num_chiplets, E), np.int64)
    for e in range(E):
        q, r = divmod(int(counts[e]), num_chiplets)
        out[:, e] = q
        for j in range(r):
            out[(e + j) % num_chiplets, e] += 1
    return LayerWorkload(counts=out, per_request=dict(per_request or {}))


def workloads_from_trace(trace, num_chiplets: int):
    """Replay a serving-engine workload trace into simulator workloads.

    ``trace`` is ``Engine.trace``: records with ``iter`` / ``layer`` /
    ``counts`` (see README trace-format spec; prefill-chunk and decode
    records both qualify, event records without ``counts`` —
    cache_hit/preempt/restore — are skipped).
    Returns ``[(iter, layer, LayerWorkload)]``
    in trace order — feed each through ``sim.engine.simulate_layer`` or
    ``sim.modes`` to cross-validate the engine's schedule decisions.
    """
    return [(int(rec["iter"]), int(rec["layer"]),
             workload_from_counts(rec["counts"], num_chiplets))
            for rec in trace if "counts" in rec]


def trace_expert_totals(trace) -> Dict[int, np.ndarray]:
    """Aggregate a serving-engine trace to per-layer expert loads.

    The engine<->simulator conformance check: these totals must equal
    the summed ``expert_totals`` of the replayed workloads exactly.
    """
    totals: Dict[int, np.ndarray] = {}
    for rec in trace:
        if "counts" not in rec:
            continue                    # cache_hit/preempt/restore events
        c = np.asarray(rec["counts"], np.int64)
        layer = int(rec["layer"])
        if layer in totals:
            totals[layer] = totals[layer] + c
        else:
            totals[layer] = c.copy()
    return totals


def iteration_workloads(spec: ModelSpec, tokens_per_iter: int,
                        num_chiplets: int, seed: int) -> List[LayerWorkload]:
    """One workload per MoE layer for a single forward iteration."""
    reqs = make_requests(tokens_per_iter, num_chiplets, seed)
    return [make_layer_workload(spec, reqs, num_chiplets, l, seed)
            for l in range(spec.num_layers)]

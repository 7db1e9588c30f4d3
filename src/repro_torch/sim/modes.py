"""Step-level chiplet simulation of the three FSE-DP *SPMD* modes (port
of ``repro.sim.modes``).

``sim.engine`` simulates the paper's trajectory scheduler at micro-slice
event granularity; this module simulates the three shard_map execution
modes of ``core.fse_dp`` (stream / index / slice) on the same
:class:`~repro_torch.sim.hardware.HardwareConfig`, so the analytical cost
model in ``core.autotune`` has an independent, discrete referee:

* stream — tokens seq-sharded, weight micro-slices ``ppermute`` around
  the P-ring; per ring step each chiplet forwards the resident slice
  (async, port-serialized) while computing on it; DDR streams the local
  shard in micro-slice granules that the first pass consumes;
* index  — identical ring, but tokens are replicated: add the input
  all-gather and the fp32 output all-reduce (ring collectives);
* slice  — weights stationary; every chiplet routes ALL tokens against
  its d_expert/P slice, then the fp32 partial outputs are all-reduced.

The event structure (per-chiplet busy time, per-link transfer chains,
pipeline fill, DDR overlap) is deliberately *not* closed-form, so rank
agreement between ``autotune.mode_cost`` and ``simulate_mode`` is a
meaningful check rather than an identity.

In the port, :func:`simulate_mode` and :func:`rank_families` referee
``core.autotune.mode_cost`` / ``ep_cost`` and ``core.strategy.
family_costs``; :func:`simulate_trajectory` and :func:`replay_trace`
referee ``core.autotune.ServingCostModel`` (the ``modeled_s`` of every
trace record), and :func:`simulate_hybrid` referees
``core.autotune.hybrid_cost``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .hardware import HardwareConfig, ModelSpec


@dataclass(frozen=True)
class ModeResult:
    mode: str
    latency: float
    compute_s: float            # per-chiplet mean busy compute seconds
    ring_bytes: float           # per-chiplet ppermute traffic
    collective_s: float         # gather + psum time (index/slice extras)
    ddr_bytes: float


def _capacity(tokens: int, spec: ModelSpec, capacity_factor: float) -> int:
    from repro_torch.configs.base import moe_capacity_rows
    return moe_capacity_rows(tokens, spec.top_k, spec.num_experts,
                             capacity_factor)


def _ring_hop_time(hw: HardwareConfig, src: int, nbytes: float) -> float:
    dst = (src + 1) % hw.num_chiplets
    hops = max(1, hw.hops(src, dst))
    return nbytes / hw.d2d_gbps + hops * hw.d2d_hop_latency


def _allreduce_time(hw: HardwareConfig, nbytes_per_chip: float) -> float:
    """Ring all-reduce: 2(P-1) steps of 1/P-sized chunks."""
    P = hw.num_chiplets
    if P <= 1:
        return 0.0
    chunk = nbytes_per_chip / P
    step = max(_ring_hop_time(hw, c, chunk) for c in range(P))
    return 2 * (P - 1) * step


def _allgather_time(hw: HardwareConfig, nbytes_per_chip: float) -> float:
    P = hw.num_chiplets
    if P <= 1:
        return 0.0
    chunk = nbytes_per_chip / P
    step = max(_ring_hop_time(hw, c, chunk) for c in range(P))
    return (P - 1) * step


def _load_rows(E: int, C: int, assignments: float, loads) -> tuple:
    """(effective expert rows, active expert count) — the discrete twin
    of ``core.autotune.load_rows``.  ``loads`` is a normalized
    per-expert share vector; ``None`` keeps the padded E*C model."""
    if loads is None:
        return float(E * C), E
    l = np.asarray(loads, np.float64)
    r = np.minimum(float(C), assignments * l)
    return float(r.sum()), max(1, int((r >= 0.5).sum()))


def simulate_mode(hw: HardwareConfig, spec: ModelSpec, mode: str,
                  tokens: int, *, micro_slices: int = 1,
                  capacity_factor: float = 1.25,
                  act_bytes: Optional[int] = None,
                  loads=None) -> ModeResult:
    """Latency of one MoE layer executed in one FSE-DP SPMD mode.

    ``tokens`` is the global token count of the iteration (B*S); tokens
    split uniformly over chiplets, matching the seq-sharded layout.
    ``loads`` (a normalized per-expert load vector) switches the expert
    terms from the padded-capacity model to the observed-gating model:
    rows scale with the actual per-expert assignments and idle experts
    skip their DDR weight stream — the discrete referee of the
    load-aware cost model (``core.autotune.mode_cost(load=...)``).
    """
    P = hw.num_chiplets
    E, d, de = spec.num_experts, spec.d_model, spec.d_expert
    wb = spec.bytes_per_param or hw.bytes_per_param
    ab = act_bytes if act_bytes is not None else hw.bytes_per_act
    de_loc = de / P
    n_mats = spec.n_mats

    if mode not in ("stream", "index", "slice"):
        raise ValueError(mode)

    # ---- per-chiplet routed capacity rows --------------------------------
    if mode in ("stream", "index"):
        T_loc = tokens / P
        C = _capacity(max(1, math.ceil(T_loc)), spec, capacity_factor)
    else:
        T_loc = tokens
        C = _capacity(max(1, tokens), spec, capacity_factor)
    rows, active = _load_rows(E, C, T_loc * spec.top_k, loads)

    # dispatch/combine one-hots + router, charged as compute on every chip
    dispatch_flops = 2.0 * T_loc * E * C * d * 2 + 2.0 * T_loc * d * E
    ddr_shard = n_mats * active * d * de_loc * wb     # local weight shard

    if mode == "slice":
        flops = 2.0 * n_mats * rows * d * de_loc + dispatch_flops
        t_comp = flops / hw.tops
        t_ddr = ddr_shard / (hw.ddr_total / P)
        t_gather = _allgather_time(hw, tokens * d * ab)
        t_psum = _allreduce_time(hw, tokens * d * 4)
        lat = t_gather + max(t_comp, t_ddr) + t_psum
        return ModeResult("slice", lat, t_comp, 0.0, t_gather + t_psum,
                          ddr_shard * P)

    # ---- stream/index: discrete ring of P steps x M micro-slices ---------
    M = max(1, min(micro_slices, int(de_loc) or 1))
    slice_de = de_loc / M
    slice_bytes = n_mats * active * d * slice_de * wb
    comp_step = (2.0 * n_mats * rows * d * slice_de
                 + dispatch_flops / (P * M)) / hw.tops

    # DDR streams the local shard micro-slice by micro-slice; slice m of
    # the first ring pass cannot start before its granule has landed
    ddr_rate = hw.ddr_total / P
    ddr_done = [(m + 1) * slice_bytes / ddr_rate for m in range(M)]

    busy = np.zeros(P)
    port_free = np.zeros(P)
    ring_bytes = 0.0
    for m in range(M):
        arrive = np.full(P, ddr_done[m])
        for s in range(P):
            send_done = np.zeros(P)
            for c in range(P):
                start = max(busy[c], arrive[c])
                if s < P - 1:        # forward first (async), then compute
                    t0 = max(start, port_free[c])
                    send_done[c] = t0 + _ring_hop_time(hw, c, slice_bytes)
                    port_free[c] = send_done[c]
                    ring_bytes += slice_bytes
                busy[c] = start + comp_step
            arrive = np.roll(send_done, 1)
    lat = float(busy.max())

    t_gather = t_psum = 0.0
    if mode == "index":
        t_gather = _allgather_time(hw, tokens * d * ab)
        t_psum = _allreduce_time(hw, tokens * d * 4)
        lat = t_gather + lat + t_psum

    return ModeResult(mode, lat, float(busy.mean()), ring_bytes / P,
                      t_gather + t_psum, ddr_shard * P)


def simulate_ep(hw: HardwareConfig, spec: ModelSpec, tokens: int, *,
                capacity_factor: float = 1.25,
                act_bytes: Optional[int] = None,
                loads=None) -> ModeResult:
    """Latency of one MoE layer under the EP baseline family
    (``core.baselines.moe_ep``): tokens stay sharded, every chiplet owns
    E/P full experts, dispatched rows all-to-all to the owner and back.

    The all-to-all is simulated as discrete port-serialized peer
    messages over the 2D mesh (per-source send chains with Manhattan
    hop latency), deliberately not the closed-form ``(P-1)/P`` bytes
    the cost model (``autotune.ep_cost``) uses — so cross-family rank
    agreement is a meaningful check, matching the stream/index ring.

    ``loads`` (a normalized per-expert load vector) switches the expert
    terms from the padded-capacity model to the observed-gating model:
    dispatch rows, expert compute, and the local weight-shard stream
    scale with the actual assignments (``None`` is bit-identical to the
    padded model).
    """
    P = hw.num_chiplets
    E, d, de = spec.num_experts, spec.d_model, spec.d_expert
    if E % P:
        raise ValueError(f"EP needs E % P == 0 (E={E}, P={P})")
    ab = act_bytes if act_bytes is not None else hw.bytes_per_act
    E_loc = E // P
    T_loc = tokens / P
    C = _capacity(max(1, math.ceil(T_loc)), spec, capacity_factor)
    rows, active = _load_rows(E, C, T_loc * spec.top_k, loads)

    # one a2a phase: each source sends (P-1) peer messages of its
    # per-destination dispatch rows (rows/E routed rows per expert, E_loc
    # experts per destination), serialized on the source's port
    msg = (rows / E) * E_loc * d * ab
    t_a2a = max(
        sum(msg / hw.d2d_gbps + hw.hops(src, (src + s) % P)
            * hw.d2d_hop_latency for s in range(1, P))
        for src in range(P))

    dispatch_flops = 2.0 * T_loc * E * C * d * 2 + 2.0 * T_loc * d * E
    flops = 2.0 * spec.n_mats * rows * d * de + dispatch_flops
    t_comp = flops / hw.tops
    ddr = spec.n_mats * (active / E) * E_loc * d * de \
        * (spec.bytes_per_param or hw.bytes_per_param)
    t_ddr = ddr / (hw.ddr_total / P)
    lat = t_a2a + max(t_comp, t_ddr) + t_a2a
    return ModeResult("ep", lat, t_comp, 0.0, 2 * t_a2a, ddr * P)


def simulate_hybrid(hw: HardwareConfig, spec: ModelSpec, tokens: int, *,
                    capacity_factor: float = 1.25,
                    act_bytes: Optional[int] = None,
                    loads=None, hot_ids=None) -> ModeResult:
    """Latency of one MoE layer under two-tier hot/cold placement
    (``core.strategy`` ``hybrid``): hot experts stream through the fast
    chiplet array as a double-buffered expert flow (DDR load chain +
    D2D ring broadcast feeding whole-array compute), cold experts
    execute *in place* on the near-memory tier (``hw.ndp``), and the
    layer finishes at ``max(tier_fast, tier_ndp)``.

    Discrete twin of ``core.autotune.hybrid_cost``: serial per-expert
    load/compute chains per tier instead of closed-form aggregates, so
    rank agreement between the two is a meaningful check.  The
    structural tax of global placement is modeled too: routing +
    capacity dispatch run un-sharded on one fast die before the tiers
    start (the hot/cold partition is not aligned with any token
    sharding).

    ``hot_ids`` pins the fast-tier expert set (e.g. the static top-N
    baseline, or the engine's EMA partition); ``None`` sweeps every
    prefix of the load-descending expert order and keeps the best —
    the idealized dynamic repartition.  ``loads`` as in
    :func:`simulate_mode`; ``None`` models uniform padded capacity.
    """
    if hw.ndp is None:
        raise ValueError("simulate_hybrid needs a near-memory tier "
                         "(HardwareConfig.ndp)")
    P = hw.num_chiplets
    E, d, de = spec.num_experts, spec.d_model, spec.d_expert
    wb = spec.bytes_per_param or hw.bytes_per_param
    ab = act_bytes if act_bytes is not None else hw.bytes_per_act
    eb = spec.n_mats * d * de * wb
    C = _capacity(max(1, tokens), spec, capacity_factor)
    if loads is None:
        rows_e = np.full(E, float(C))
    else:
        l = np.asarray(loads, np.float64)
        rows_e = np.minimum(float(C), tokens * spec.top_k * l)

    # un-sharded routing + capacity dispatch on one fast die — the
    # centralization tax of global hot/cold placement
    dispatch_flops = 2.0 * tokens * E * C * d * 2 + 2.0 * tokens * d * E
    t_dispatch = dispatch_flops / hw.tops

    def _tiers(hot: frozenset) -> float:
        # fast tier: serial DDR chain + ring broadcast feeding the
        # whole-array compute chain, double-buffered (one flow)
        load_done = comp_done = 0.0
        order = np.argsort(-rows_e, kind="stable")
        for e in order:
            r = rows_e[int(e)]
            if loads is not None and r < 0.5:
                continue                       # dynamic flow skips idle
            flops = 2.0 * spec.n_mats * r * d * de
            if int(e) in hot:
                load_done += eb / hw.ddr_total
                ring = load_done + (P - 1) * (eb / (P * hw.d2d_gbps)
                                              + hw.d2d_hop_latency)
                comp_done = max(comp_done, ring) \
                    + flops / (hw.tops * P)
        # near-memory tier: serial per-expert compute/local-read overlap
        ndp_done = 0.0
        cold_rows = 0.0
        for e in range(E):
            r = rows_e[e]
            if e in hot or (loads is not None and r < 0.5):
                continue
            flops = 2.0 * spec.n_mats * r * d * de
            ndp_done += max(flops / hw.ndp.tops, eb / hw.ndp.gbps)
            cold_rows += r
        if cold_rows:
            # dispatched rows shuttle to the memory tier and back
            ndp_done += 2.0 * cold_rows * d * ab / hw.d2d_gbps \
                + 2.0 * hw.d2d_hop_latency
        return max(comp_done, ndp_done)

    if hot_ids is not None:
        best = _tiers(frozenset(int(e) for e in hot_ids))
    else:
        desc = np.argsort(-rows_e, kind="stable")
        best = min(_tiers(frozenset(int(e) for e in desc[:H]))
                   for H in range(E + 1))
    lat = t_dispatch + best
    return ModeResult("hybrid", lat, best, 0.0, t_dispatch, eb * E)


def simulate_trajectory(hw: HardwareConfig, spec: ModelSpec, counts, *,
                        order=None, padded: bool = False,
                        capacity_factor: float = 1.25,
                        resident=None) -> float:
    """Step time of one MoE layer executed as a double-buffered expert
    *flow*: DDR streams expert weights in trajectory order while the
    array computes the previously-loaded expert (paper Fig. 4/5).

    ``counts`` are per-expert token-activation counts; ``order`` the
    trajectory (expert visit order — ``None`` = canonical index order);
    ``padded`` models the shape-only static plan, which knows nothing of
    the gating: every expert is loaded and computed at its full
    capacity-padded row count.  A dynamic (count-built) trajectory skips
    idle experts and computes the observed rows — and its hot/cold
    pairing keeps the DDR stream hidden behind compute instead of
    piling memory-bound experts into a compute-idle tail.

    Serial-resource model: one DDR load chain (total array bandwidth)
    feeding one compute chain (total array throughput), double-buffered
    — ``load_done(i+1)`` may run during ``compute(i)``.  Deliberately
    not the closed-form cost model, so dynamic-vs-static comparisons
    against ``core.autotune``'s load-aware predictions are meaningful.

    ``resident`` is an iterable of expert ids whose weights are pinned
    on-package by the EMA-hot weight tier (``docs/quantization.md``):
    those experts compute without touching the DDR chain at all, so a
    trajectory that leads with its resident experts hides the cold
    tail's stream behind their compute.
    """
    counts = np.asarray(counts, np.float64)
    E = spec.num_experts
    tokens = counts.sum() / max(1, spec.top_k)
    C = _capacity(max(1, int(math.ceil(tokens))), spec, capacity_factor)
    if order is None:
        order = range(E)
    resident = frozenset(int(e) for e in resident) if resident else frozenset()
    tops = hw.tops * hw.num_chiplets
    ddr = hw.ddr_total
    t_load = spec.expert_bytes_on(hw) / ddr
    load_done = 0.0
    comp_done = 0.0
    for e in order:
        rows = C if padded else min(C, counts[int(e)])
        if not padded and rows <= 0:
            continue                       # dynamic trajectory skips idle
        flops = 2.0 * spec.n_mats * rows * spec.d_model * spec.d_expert
        if int(e) in resident:
            comp_done = comp_done + flops / tops   # no DDR stream at all
            continue
        load_done = load_done + t_load     # serial DDR stream
        comp_done = max(comp_done, load_done) + flops / tops
    return comp_done


def replay_trace(hw: HardwareConfig, spec: ModelSpec, trace, *,
                 capacity_factor: float = 1.25) -> float:
    """Total modeled seconds of a serving-engine workload trace, replayed
    record by record through :func:`simulate_trajectory` — the discrete
    event-loop referee of the engine's closed-form per-record clock
    (``autotune.ServingCostModel`` / the ``modeled_s`` field, see
    docs/trace-format.md and docs/benchmarks.md).

    Each record is one MoE layer's observed expert counts for one
    iteration.  Dynamic-schedule records replay along their recorded EMA
    trajectory (falling back to the record's paired-load ``order``);
    static records replay the shape-only capacity-padded plan.  Records
    with no routed tokens are skipped (no expert flow, no step time).
    Records carrying a ``resident`` list (the engine's EMA-hot weight
    tier) skip those experts' DDR loads during replay.  Records carrying
    a ``hot`` list (the hybrid strategy's fast-tier partition) replay
    through :func:`simulate_hybrid` when the hardware has a near-memory
    tier (on homogeneous hardware the partition is placement-only and
    the record replays like any other).
    """
    total = 0.0
    for rec in trace:
        if "counts" not in rec:
            continue                    # cache_hit/preempt/restore events
        counts = np.asarray(rec["counts"], np.float64)
        if counts.sum() <= 0:
            continue
        if hw.ndp is not None and rec.get("hot") is not None:
            tokens = max(1, int(math.ceil(counts.sum()
                                          / max(1, spec.top_k))))
            total += simulate_hybrid(
                hw, spec, tokens, capacity_factor=capacity_factor,
                loads=counts / counts.sum(),
                hot_ids=rec["hot"]).latency
            continue
        resident = rec.get("resident")
        if rec.get("schedule") == "dynamic":
            order = rec.get("trajectory")
            if order is None:
                order = rec["order"]
            total += simulate_trajectory(hw, spec, counts, order=order,
                                         capacity_factor=capacity_factor,
                                         resident=resident)
        else:
            total += simulate_trajectory(hw, spec, counts, padded=True,
                                         capacity_factor=capacity_factor,
                                         resident=resident)
    return total


def schedule_step_times(hw: HardwareConfig, spec: ModelSpec, counts, *,
                        capacity_factor: float = 1.25) -> Dict[str, float]:
    """Static-vs-dynamic trajectory step times for one observed gating.

    ``static`` is the shape-only plan (canonical order, capacity-padded,
    loads every expert); ``dynamic`` the count-built paired-load
    trajectory (``core.policies.paired_load_order``); ``dynamic_unpaired``
    isolates the pairing gain (same skipping/rows, canonical order).
    """
    from repro_torch.core.policies import paired_load_order
    return {
        "static": simulate_trajectory(hw, spec, counts, padded=True,
                                      capacity_factor=capacity_factor),
        "dynamic": simulate_trajectory(hw, spec, counts,
                                       order=paired_load_order(counts),
                                       capacity_factor=capacity_factor),
        "dynamic_unpaired": simulate_trajectory(
            hw, spec, counts, capacity_factor=capacity_factor),
    }


def rank_families(hw: HardwareConfig, spec: ModelSpec, tokens: int, *,
                  B: int, S: int,
                  capacity_factor: float = 1.25,
                  loads=None) -> Dict[str, float]:
    """Simulated latency per execution *family* of the (B, S) shape —
    the independent referee of the cross-family ``auto`` planner
    (``core.strategy.family_costs`` in the reference).

    ``fse_dp`` is the best ring (stream/index) schedule over its
    micro-slice candidates; when no ring layout lowers the family is
    out of the race (its degraded slice dataflow is exactly ``tp``,
    which has its own entry).  ``ep`` is the discrete all-to-all
    simulation when E % P == 0 and the tokens can seq- or batch-shard.
    ``hybrid`` (two-tier hot/cold placement) joins the race only when
    the hardware carries a near-memory tier (``hw.ndp``).  ``loads``
    conditions every family on a normalized per-expert load vector,
    mirroring ``family_costs(load=...)``.
    """
    from repro_torch.core.autotune import _micro_candidates, feasible_modes
    from repro_torch.core.strategy import ep_feasible
    P = hw.num_chiplets
    de_loc = max(1, spec.d_expert // P)
    out: Dict[str, float] = {}
    ring = [m for m in feasible_modes(B, S, P) if m != "slice"]
    if ring:
        out["fse_dp"] = min(
            simulate_mode(hw, spec, m, tokens, micro_slices=M,
                          capacity_factor=capacity_factor,
                          loads=loads).latency
            for m in ring for M in _micro_candidates(de_loc, 0))
    if ep_feasible(B, S, spec.num_experts, P):
        out["ep"] = simulate_ep(hw, spec, tokens,
                                capacity_factor=capacity_factor,
                                loads=loads).latency
    out["tp"] = simulate_mode(hw, spec, "slice", tokens,
                              capacity_factor=capacity_factor,
                              loads=loads).latency
    if hw.ndp is not None:
        out["hybrid"] = simulate_hybrid(hw, spec, tokens,
                                        capacity_factor=capacity_factor,
                                        loads=loads).latency
    return out


def rank_modes(hw: HardwareConfig, spec: ModelSpec, tokens: int, *,
               B: int, S: int, micro_slices: Optional[int] = None,
               capacity_factor: float = 1.25) -> Dict[str, float]:
    """Simulated latency for every *feasible* mode of the (B, S) shape.

    With ``micro_slices=None`` each ring mode is simulated at its own best
    micro-slice count (mirroring the planner, which also optimizes M per
    mode) so the comparison is schedule-vs-schedule, not knob-vs-knob.
    """
    from repro_torch.core.autotune import _micro_candidates, feasible_modes
    P = hw.num_chiplets
    de_loc = max(1, spec.d_expert // P)
    out = {}
    for mode in feasible_modes(B, S, P):
        cands = [micro_slices] if micro_slices or mode == "slice" \
            else _micro_candidates(de_loc, 0)
        out[mode] = min(
            simulate_mode(hw, spec, mode, tokens, micro_slices=m or 1,
                          capacity_factor=capacity_factor).latency
            for m in cands)
    return out

"""The autotune level, the Hopper tile planner of ``streamed_moe``, the
distributed planner and the serving engine's modeled chiplet clock (port
of ``repro.core.autotune``).

**The level** (``use_autotune``, ``autotune_level``; ``REPRO_AUTOTUNE``
sets the default, ``analytic``): ``off`` launches the kernel's default
tiles, ``analytic`` the tiles :func:`plan_kernel_tiles` scores best, and
``measured`` the fastest of a few candidates timed once on the card and
kept on disk (:func:`measured_kernel_tiles`).  :func:`kernel_opts_for` is
the dispatch ``kernels.ops.streamed_moe_autotuned`` asks.

**The planner** is the counterpart of the reference's VMEM / HBM tile
scoring, rebuilt for the CUDA kernel and the card (:class:`CardProfile`):
a setting of ``kernels.streamed_moe.TILE_SETTINGS`` must fit the block's
shared memory and 255 registers a thread without spilling (on the card
the registers and spills are the compiled kernel's, from
``cudaFuncGetAttributes``; on the CPU an estimate), and is priced
(:func:`tile_cost`) as the larger of a compute time (tensor-core
operations, the tiles its blocks load from L2 and its ring stages, at
rates measured on the card, times its wave quantisation) and a memory
time (device-memory bytes over the bandwidth).  The default setting is
always a candidate and wins ties: a setting must be predicted ``TIE``
faster to replace it.

**The modeled clock**: :class:`ServingCostModel` turns each workload-trace
record (observed per-expert counts and the schedule policy) into
closed-form seconds of the paper's chiplet array: DDR streams expert
weights in trajectory order while the array computes the expert loaded
before (double-buffered).  The profile is pure Table-I constants
(:mod:`repro_torch.sim.hardware`), so the modeled TTFT / TPOT are the same
on every machine; they describe the modeled array, never the card the
port runs on.

**The two tiers**: on a profile with a near-memory tier
(``HardwareProfile.ndp_flops`` / ``ndp_bw``, from ``sim.hardware.with_ndp``)
:func:`hybrid_cost` prices the ``hybrid`` strategy's hot prefix on the
fast array against its cold tail executed in place near memory, and
``ServingCostModel.layer_s(hot=...)`` prices a trace record's partition
the same way; on homogeneous hardware the partition is placement only and
``hot`` is ignored.  :class:`Plan` carries the decision (its fields only:
the Hopper planner's :func:`kernel_opts_for` stands where the reference's
``Plan.kernel_opts`` would).

**The distributed planner** (:func:`plan_moe`, :func:`mode_cost`,
:func:`ep_cost`, :func:`fallback_plan`) scores the FSE-DP modes
{stream, index, slice} x micro-slices on a :class:`HardwareProfile`
(``detect`` is the modeled chiplet, as the reference's off a TPU), so a
plan's mode, micro-slices, predicted seconds and per-mode breakdown are
the reference's.  Its tiles are not: the reference scores TPU tiles
against VMEM (``tile_vmem_bytes``, ``kernel_tile_cost``, not ported),
the port asks the Hopper planner (:func:`kernel_opts_for`) for the
plan's kernel shape and keeps the setting in ``Plan.tiles``; the
reference's tile fields (``token_tile``, ``dmodel_tile``,
``dexpert_tile``, ``vmem_bytes``) stay at their defaults.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import math
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import moe_capacity_rows
from repro_torch.kernels.quant import WEIGHT_DTYPES

LEVELS = ("off", "analytic", "measured")

# (B, S, E, d_expert, P) validation sweep of the distributed planner, as
# the reference's: low-batch decode (slice regime), prefill (stream
# regime) and batch-heavy decode with S < P (index regime), at d_model =
# 512 on the Table-I chiplet arrays
VALIDATION_SWEEP: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 1, 16, 512, 4), (8, 1, 16, 512, 4), (4, 16, 8, 256, 4),
    (1, 128, 16, 512, 4), (1, 2, 64, 256, 8),
    (4, 512, 16, 512, 4), (2, 1024, 8, 1024, 2), (8, 1024, 32, 512, 8),
    (512, 1, 32, 256, 8), (2048, 1, 16, 512, 4), (1024, 2, 64, 256, 8),
    (16, 1, 8, 1024, 2), (3, 1, 16, 512, 4), (2, 2048, 16, 768, 4),
)
# autotune level: "off" (the kernel's default tiles), "analytic" (the
# planner's tiles, the default), "measured" (timed tiles, cached on disk)
_LEVEL = contextvars.ContextVar(
    "repro_torch_autotune",
    default=os.environ.get("REPRO_AUTOTUNE", "analytic"))


@contextlib.contextmanager
def use_autotune(level: str):
    """Scope the autotune level: 'off' | 'analytic' | 'measured'."""
    if level not in LEVELS:
        raise ValueError(f"unknown autotune level {level!r}")
    tok = _LEVEL.set(level)
    try:
        yield
    finally:
        _LEVEL.reset(tok)


def autotune_level() -> str:
    return _LEVEL.get()


@dataclass(frozen=True)
class HardwareProfile:
    """What the cost model needs to know about one device and its links."""

    name: str
    peak_flops: float          # per-device peak FLOP/s
    mem_bw: float              # DDR bytes/s per device
    link_bw: float             # D2D bytes/s per device (ring neighbour)
    link_latency: float        # seconds per ring hop
    vmem_bytes: int            # fast-memory budget for one working set
    # near-memory compute tier (HardwareConfig.ndp), tier totals;
    # None / 0.0 = homogeneous hardware
    ndp_flops: Optional[float] = None
    ndp_bw: float = 0.0

    @classmethod
    def from_chiplet(cls, hw=None) -> "HardwareProfile":
        """One chiplet of a HardwareConfig (Table I)."""
        if hw is None:
            from repro_torch.sim.hardware import PROTOTYPE_2X2 as hw
        ndp = hw.ndp
        return cls(name=f"chiplet-{hw.rows}x{hw.cols}",
                   peak_flops=hw.tops,
                   mem_bw=hw.ddr_total / hw.num_chiplets,
                   link_bw=hw.d2d_gbps,
                   link_latency=hw.d2d_hop_latency,
                   vmem_bytes=hw.buffer_bytes,
                   ndp_flops=None if ndp is None else ndp.tops,
                   ndp_bw=0.0 if ndp is None else ndp.gbps)

    @classmethod
    def detect(cls) -> "HardwareProfile":
        """The profile the planner prices the distributed modes on: one
        chiplet of the modeled array (Table I), the reference's choice on
        every backend but a TPU, so the port plans exactly as the
        reference does on the CPU and on the card."""
        return cls.from_chiplet()

    @classmethod
    def from_chiplet_array(cls, hw=None) -> "HardwareProfile":
        """The whole array (Table I, all chiplets summed): total MAC
        throughput feeding on total DDR bandwidth, the profile of the
        serving engine's modeled clock."""
        if hw is None:
            from repro_torch.sim.hardware import PROTOTYPE_2X2 as hw
        ndp = hw.ndp
        return cls(name=f"chiplet-array-{hw.rows}x{hw.cols}",
                   peak_flops=hw.tops * hw.num_chiplets,
                   mem_bw=hw.ddr_total,
                   link_bw=hw.d2d_gbps,
                   link_latency=hw.d2d_hop_latency,
                   vmem_bytes=hw.buffer_bytes,
                   ndp_flops=None if ndp is None else ndp.tops,
                   ndp_bw=0.0 if ndp is None else ndp.gbps)


@dataclass(frozen=True)
class Plan:
    """One resolved MoE execution decision.  ``family`` names the
    ``core.strategy`` registry key that owns the plan, ``mode`` the
    dataflow (the family's own name outside FSE-DP); ``hot_experts`` is
    the ``hybrid`` family's fast-tier expert count."""

    mode: str                          # stream | index | slice | <family>
    micro_slices: int
    family: str = "fse_dp"
    token_tile: int = 128
    dmodel_tile: Optional[int] = None
    dexpert_tile: Optional[int] = None
    predicted_s: float = 0.0
    vmem_bytes: int = 0
    per_mode_s: Tuple[Tuple[str, float], ...] = ()
    source: str = "analytic"           # analytic | measured | fallback | forced
    hot_experts: Optional[int] = None  # hybrid family: fast-tier expert count
    # the Hopper planner's streamed_moe setting for the plan's kernel shape
    # (``kernels.streamed_moe.TILE_SETTINGS``); None: chosen per call
    tiles: Optional[str] = None

    def kernel_opts(self) -> Dict[str, str]:
        """kwargs for ``kernels.ops.streamed_moe`` (``{}``: none planned)."""
        return {} if self.tiles is None else {"tiles": self.tiles}

    @property
    def breakdown(self) -> Dict[str, float]:
        """Predicted seconds by candidate (``per_mode_s`` as a dict)."""
        return dict(self.per_mode_s)


def _cap(tokens: int, top_k: int, E: int, cf: float) -> int:
    return moe_capacity_rows(tokens, top_k, E, cf)


def load_rows(E: int, C: int, assignments: float,
              load: Optional[Tuple[float, ...]] = None
              ) -> Tuple[float, int]:
    """(effective expert rows, active expert count) under a load vector.

    ``load=None`` is the shape-only padded plan: every expert computes its
    full capacity ``C``.  With a normalized per-expert share vector,
    expert ``e`` computes ``min(C, assignments * load_e)`` rows and idle
    experts (< 0.5 expected rows) skip their weight load."""
    if load is None:
        return float(E * C), E
    rows = 0.0
    active = 0
    for share in load:
        r = min(float(C), assignments * float(share))
        rows += r
        active += r >= 0.5
    return rows, max(1, active)


def streaming_layer_cost(E: int, C: int, d: int, de: int, n_mats: int,
                         assignments: float, profile: HardwareProfile, *,
                         dtype_bytes: int = 2,
                         weight_bytes: Optional[int] = None,
                         resident: int = 0,
                         load: Optional[Tuple[float, ...]] = None
                         ) -> Dict[str, float]:
    """Closed-form seconds of one MoE layer run as the paper's expert
    flow: ``fill + max(compute chain, remaining DDR chain)``, the first
    expert's load exposed and the rest overlapped with compute.

    ``weight_bytes`` is the streamed bytes per expert-weight param
    (``None`` = ``dtype_bytes``); ``resident`` experts pay no DDR stream
    and, when any is resident, hide the first cold expert's fill."""
    rows, active = load_rows(E, C, assignments, load)
    wb = dtype_bytes if weight_bytes is None else weight_bytes
    expert_bytes = float(n_mats * d * de * wb)
    cold = max(0, active - max(0, int(resident)))
    t_comp = 2.0 * n_mats * rows * d * de / profile.peak_flops
    t_ddr = cold * expert_bytes / profile.mem_bw
    t_fill = expert_bytes / profile.mem_bw if cold == active and cold else 0.0
    return {"total_s": t_fill + max(t_comp, t_ddr - t_fill),
            "t_comp_s": t_comp, "t_ddr_s": t_ddr, "t_fill_s": t_fill,
            "rows": rows, "active": float(active), "cold": float(cold)}


@dataclass(frozen=True)
class ServingCostModel:
    """Per-MoE-layer modeled seconds for the serving engine's clock.

    A static schedule prices the shape-only padded plan, a dynamic one the
    observed load along the trajectory.  ``dtype_bytes`` is the
    prototype's bf16 whatever the engine's dtype (the clock models the
    chiplet array); ``weight_bytes`` overrides the streamed expert-weight
    width (int8 / fp8)."""

    profile: HardwareProfile
    num_experts: int
    d_model: int
    d_expert: int
    n_mats: int
    top_k: int
    capacity_factor: float
    dtype_bytes: int = 2
    weight_bytes: Optional[int] = None

    @classmethod
    def from_config(cls, cfg, profile: Optional[HardwareProfile] = None,
                    weight_bytes: Optional[int] = None) -> "ServingCostModel":
        """Build from a ModelConfig (must have MoE)."""
        assert cfg.moe is not None, "cost model needs an MoE config"
        return cls(profile=profile or HardwareProfile.from_chiplet_array(),
                   num_experts=cfg.moe.num_experts, d_model=cfg.d_model,
                   d_expert=cfg.moe.d_expert,
                   n_mats=3 if cfg.activation == "swiglu" else 2,
                   top_k=cfg.moe.top_k,
                   capacity_factor=cfg.moe.capacity_factor,
                   weight_bytes=weight_bytes)

    @property
    def expert_bytes(self) -> int:
        """Streamed DDR bytes of one expert's weights."""
        wb = self.dtype_bytes if self.weight_bytes is None else self.weight_bytes
        return int(self.n_mats * self.d_model * self.d_expert * wb)

    def layer_s(self, counts, *, dynamic: bool = False, resident: int = 0,
                hot=None) -> float:
        """Modeled seconds for one layer's observed expert counts;
        ``resident`` experts skip their DDR stream.  ``hot`` is the
        hybrid strategy's fast-tier expert ids: on a two-tier profile the
        layer prices as the slower of the fast flow over ``hot`` and the
        near-memory tier over the rest; on homogeneous hardware it is
        ignored (every expert still streams)."""
        total = float(sum(float(c) for c in counts))
        tokens = max(1, math.ceil(total / max(1, self.top_k)))
        C = _cap(tokens, self.top_k, self.num_experts, self.capacity_factor)
        if hot is not None and self.profile.ndp_flops and self.profile.ndp_bw:
            return self._hybrid_tiers_s(counts, C, frozenset(
                int(e) for e in hot), dynamic and total > 0)
        load = None
        if dynamic and total > 0:
            load = tuple(float(c) / total for c in counts)
        return streaming_layer_cost(
            self.num_experts, C, self.d_model, self.d_expert, self.n_mats,
            total, self.profile, dtype_bytes=self.dtype_bytes,
            weight_bytes=self.weight_bytes, resident=resident,
            load=load)["total_s"]

    def _hybrid_tiers_s(self, counts, C: int, hotset: frozenset,
                        dynamic: bool) -> float:
        """Two-tier pricing against the aggregate array profile: the hot
        tier is the usual streaming flow (fill + overlapped compute/DDR
        chains), the cold tier executes in place near memory plus a
        token shuttle over D2D; the layer is their ``max``."""
        p = self.profile
        eb = float(self.expert_bytes)
        fl = 2.0 * self.n_mats * self.d_model * self.d_expert
        hot_rows = cold_rows = 0.0
        hot_active = cold_active = 0
        for e in range(self.num_experts):
            r = min(float(C), float(counts[e])) if dynamic else float(C)
            if dynamic and r < 0.5:
                continue
            if e in hotset:
                hot_rows += r
                hot_active += 1
            else:
                cold_rows += r
                cold_active += 1
        t_hot = 0.0
        if hot_active:
            t_fill = eb / p.mem_bw
            t_hot = t_fill + max(hot_rows * fl / p.peak_flops,
                                 hot_active * eb / p.mem_bw - t_fill)
        t_cold = 0.0
        if cold_active:
            t_cold = max(cold_rows * fl / p.ndp_flops,
                         cold_active * eb / p.ndp_bw) \
                + 2.0 * cold_rows * self.d_model * self.dtype_bytes \
                / p.link_bw
        return max(t_hot, t_cold)


# ---------------------------------------------------------------------------
# the two tiers and the shapes the distributed modes lower for
# ---------------------------------------------------------------------------


def feasible_modes(B: int, S: int, P: int) -> Tuple[str, ...]:
    """Which SPMD layouts lower for this global token shape."""
    out = []
    if S % P == 0 and S >= P:
        out.append("stream")
    if (B * S) % P == 0:
        out.append("index")
    out.append("slice")                # always lowers (weights stationary)
    return tuple(out)


def hybrid_cost(B: int, S: int, d: int, E: int, de: int, top_k: int,
                cf: float, n_mats: int, P: int, profile: HardwareProfile,
                dtype_bytes: int = 2,
                load: Optional[Tuple[float, ...]] = None,
                weight_bytes: Optional[int] = None,
                hot_n: Optional[int] = None) -> Dict[str, float]:
    """Predicted seconds for one MoE layer under two-tier hot/cold
    placement (the ``hybrid`` family): *hot* experts stream through the
    fast chiplet array as the usual double-buffered expert flow, *cold*
    experts execute in place on the near-memory tier
    (``profile.ndp_flops`` / ``ndp_bw``), and the layer finishes at
    ``max(tier_fast, tier_ndp)`` — the HD-MoE / GPU-NDP operating
    point.  Closed-form twin of ``sim.modes.simulate_hybrid`` (the
    discrete referee, in rank agreement across families through
    ``core.strategy.family_costs``).

    Global hot/cold placement is not aligned with any token sharding,
    so routing + capacity dispatch run un-sharded on ONE fast die
    before the tiers start — the centralization tax that keeps FSE-DP
    competitive at prefill.  The hot set is a prefix of the
    load-descending expert order: ``hot_n`` pins its size (static
    top-N baseline, or the engine's EMA partition width); ``None``
    sweeps every prefix and keeps the best — the idealized dynamic
    repartition.  ``load`` is a normalized per-expert share vector
    (``None``: every expert at its padded capacity); ``weight_bytes`` the
    streamed bytes per expert-weight param (``None``: ``dtype_bytes``).
    """
    if not profile.ndp_flops or not profile.ndp_bw:
        raise ValueError("hybrid_cost needs a near-memory tier "
                         "(HardwareProfile.ndp_flops / ndp_bw)")
    T = B * S
    ab = dtype_bytes
    wb = dtype_bytes if weight_bytes is None else weight_bytes
    eb = float(n_mats * d * de * wb)
    C = _cap(T, top_k, E, cf)
    if load is None:
        rows_desc = [float(C)] * E
    else:
        rows_desc = sorted((min(float(C), T * top_k * float(s))
                            for s in load), reverse=True)
    pref_rows = [0.0]
    pref_active = [0]
    for r in rows_desc:                 # prefix sums, load-descending
        act = load is None or r >= 0.5
        pref_rows.append(pref_rows[-1] + (r if act else 0.0))
        pref_active.append(pref_active[-1] + int(act))
    tot_rows, tot_active = pref_rows[-1], pref_active[-1]

    dispatch_flops = 2.0 * T * E * C * d * 2 + 2.0 * T * d * E
    t_dispatch = dispatch_flops / profile.peak_flops   # one die, un-sharded
    ddr_bw = P * profile.mem_bw                        # array-total DDR

    def _tiers(H: int) -> Tuple[float, float, float]:
        hot_rows, hot_active = pref_rows[H], pref_active[H]
        cold_rows = tot_rows - hot_rows
        cold_active = tot_active - pref_active[H]
        t_hot = 0.0
        if hot_active:
            # expert flow: exposed first load + ring broadcast, then
            # compute / DDR / ring chains overlap (double-buffered)
            t_fill = eb / ddr_bw \
                + (P - 1) * (eb / (P * profile.link_bw)
                             + profile.link_latency)
            t_comp = 2.0 * n_mats * hot_rows * d * de \
                / (P * profile.peak_flops)
            t_ddr = hot_active * eb / ddr_bw
            t_ring = hot_active * eb * (P - 1) / (P * profile.link_bw) \
                + hot_active * (P - 1) * profile.link_latency
            t_hot = t_fill + max(t_comp, t_ddr - t_fill, t_ring - t_fill)
        t_cold = 0.0
        if cold_active:
            # in-place near-memory execution + token shuttle over D2D
            t_cold = max(2.0 * n_mats * cold_rows * d * de
                         / profile.ndp_flops,
                         cold_active * eb / profile.ndp_bw)
            t_cold += 2.0 * cold_rows * d * ab / profile.link_bw \
                + 2.0 * profile.link_latency
        return max(t_hot, t_cold), t_hot, t_cold

    if hot_n is not None:
        best_H = max(0, min(E, int(hot_n)))
        best, t_hot, t_cold = _tiers(best_H)
    else:
        best = t_hot = t_cold = None
        best_H = 0
        for H in range(E + 1):
            t, th, tc = _tiers(H)
            if best is None or t < best:
                best, t_hot, t_cold, best_H = t, th, tc, H
    return {"total_s": t_dispatch + best, "dispatch_s": t_dispatch,
            "hot_s": t_hot, "cold_s": t_cold, "hot_n": float(best_H),
            "capacity": C, "rows": tot_rows, "active": float(tot_active)}


def _micro_candidates(de_loc: int, configured: int) -> List[int]:
    """Divisors of the local slice width worth trying (+ the config value)."""
    cands = {m for m in (1, 2, 4, 8, 16) if m <= de_loc and de_loc % m == 0}
    if 0 < configured <= de_loc and de_loc % configured == 0:
        cands.add(configured)
    return sorted(cands) or [1]


# ---------------------------------------------------------------------------
# the distributed planner: per-mode and EP cost curves, and plan_moe
# ---------------------------------------------------------------------------

MODES = ("stream", "index", "slice")


def mode_cost(mode: str, B: int, S: int, d: int, E: int, de: int,
              top_k: int, cf: float, n_mats: int, P: int,
              profile: HardwareProfile, micro_slices: int,
              dtype_bytes: int = 2,
              load: Optional[Tuple[float, ...]] = None,
              weight_bytes: Optional[int] = None) -> Dict[str, float]:
    """Predicted per-device seconds for one MoE layer under ``mode``,
    term by term the bodies of ``core.fse_dp``:

    stream: tokens sequence-sharded (T/P local), weight micro-slices ring
            over P·M steps overlapped with the grouped GEMM;
    index:  tokens replicated, each rank takes a T/P slice, the same
            ring, plus a token all-gather and an fp32 output psum;
    slice:  weights stationary, every rank routes and computes all tokens
            on its d_expert/P slice, fp32 output psum (no ring).

    ``load`` (normalized per-expert shares, :func:`load_rows`) prices the
    observed gating: rows follow the assignments and idle experts move
    no weights.  ``weight_bytes`` scales the weight ring and DDR terms
    (``None`` = ``dtype_bytes``)."""
    T = B * S
    ab = dtype_bytes
    wb = dtype_bytes if weight_bytes is None else weight_bytes
    de_loc = de / P
    M = max(1, micro_slices)

    if mode in ("stream", "index"):
        T_loc = T / P
        C = _cap(int(math.ceil(T_loc)), top_k, E, cf)
        rows, active = load_rows(E, C, T_loc * top_k, load)
        # the ring covers all P slices: full d_expert on the local rows
        expert_flops = 2.0 * n_mats * rows * d * de
        ring_bytes = n_mats * active * d * de_loc * wb * P
        t_ring = ring_bytes / profile.link_bw + P * M * profile.link_latency
        t_fill = ring_bytes / (P * M) / profile.link_bw
        # the last micro-slice's P compute steps trail the weight stream
        t_drain = (expert_flops / profile.peak_flops) / M
    else:
        T_loc = T
        C = _cap(T, top_k, E, cf)
        rows, active = load_rows(E, C, T_loc * top_k, load)
        expert_flops = 2.0 * n_mats * rows * d * de_loc
        ring_bytes = 0.0
        t_ring = 0.0
        t_fill = 0.0
        t_drain = 0.0

    # dispatch / combine one-hot products and the router, local tokens
    dispatch_flops = 2.0 * T_loc * E * C * d * 2 + 2.0 * T_loc * d * E
    t_comp = (expert_flops + dispatch_flops) / profile.peak_flops
    hbm = n_mats * active * d * de_loc * wb
    t_hbm = hbm / profile.mem_bw

    t_gather = t_psum = 0.0
    if mode in ("index", "slice"):
        gather_bytes = (P - 1) / P * T * d * ab
        psum_bytes = 2.0 * (P - 1) / P * T * d * 4
        t_gather = gather_bytes / profile.link_bw \
            + profile.link_latency * (P - 1)
        t_psum = psum_bytes / profile.link_bw \
            + 2 * profile.link_latency * (P - 1)

    overlapped = max(t_comp, t_ring, t_hbm + t_drain)
    total = overlapped + t_fill + t_gather + t_psum
    return {"total_s": total, "compute_s": t_comp, "ring_s": t_ring,
            "hbm_s": t_hbm, "gather_s": t_gather, "psum_s": t_psum,
            "fill_s": t_fill, "ring_bytes": ring_bytes,
            "flops": expert_flops + dispatch_flops, "capacity": C}


def ep_cost(B: int, S: int, d: int, E: int, de: int, top_k: int, cf: float,
            n_mats: int, P: int, profile: HardwareProfile,
            dtype_bytes: int = 2,
            load: Optional[Tuple[float, ...]] = None,
            weight_bytes: Optional[int] = None) -> Dict[str, float]:
    """Predicted per-device seconds for one MoE layer under expert
    parallelism (``core.baselines.moe_ep``): tokens stay sharded, each
    device owns E/P whole experts, and the dispatched rows go to their
    owner and back by two all-to-alls; no weight moves."""
    T = B * S
    ab = dtype_bytes
    wb = dtype_bytes if weight_bytes is None else weight_bytes
    T_loc = T / P
    C = _cap(int(math.ceil(T_loc)), top_k, E, cf)
    E_loc = E / P
    rows, active = load_rows(E, C, T_loc * top_k, load)
    expert_flops = 2.0 * n_mats * (rows / E) * E_loc * P * d * de
    dispatch_flops = 2.0 * T_loc * E * C * d * 2 + 2.0 * T_loc * d * E
    t_comp = (expert_flops + dispatch_flops) / profile.peak_flops
    hbm = n_mats * (active / E) * E_loc * d * de * wb
    t_hbm = hbm / profile.mem_bw
    a2a_bytes = 2.0 * (P - 1) / P * rows * d * ab
    t_a2a = a2a_bytes / profile.link_bw + 2 * (P - 1) * profile.link_latency
    total = max(t_comp, t_hbm) + t_a2a
    return {"total_s": total, "compute_s": t_comp, "hbm_s": t_hbm,
            "a2a_s": t_a2a, "a2a_bytes": a2a_bytes,
            "flops": expert_flops + dispatch_flops, "capacity": C}


def fallback_plan(B: int, S: int, P: int, micro_slices: int) -> Plan:
    """The zero-knowledge plan: the first feasible mode in stream > index
    > slice order, the configured micro-slice count, default tiles."""
    return Plan(mode=feasible_modes(B, S, P)[0], micro_slices=micro_slices,
                source="fallback")


_PICK_MODE_WARNED = False


def pick_mode(B: int, S: int, P_: int) -> str:
    """Deprecated: the zero-knowledge mode heuristic,
    ``fallback_plan(B, S, P_, 1).mode``; new callers use :func:`plan_moe`
    and read ``plan.mode``.  Warns once per process."""
    global _PICK_MODE_WARNED
    if not _PICK_MODE_WARNED:
        _PICK_MODE_WARNED = True
        warnings.warn("core.autotune.pick_mode / core.fse_dp.pick_mode is "
                      "deprecated; use autotune.plan_moe(...).mode or the "
                      "repro_torch.core.strategy registry",
                      DeprecationWarning, stacklevel=2)
    return fallback_plan(B, S, P_, 1).mode


# the streamed_moe path a plan's kernel shape takes, by bytes per element
_FORMAT_OF_BYTES = {1: "int8", 2: "bf16", 4: "fp32"}


def _plan_tiles(E: int, C: int, d: int, m: int, activation: str,
                level: str, dtype_bytes: int, weight_bytes: Optional[int],
                card: Optional["CardProfile"]) -> Optional[str]:
    """The Hopper planner's setting for the plan's kernel shape
    (:func:`kernel_opts_for`), or None where there is neither a card nor
    a given ``card`` profile: each call then plans its own tiles."""
    if card is None:
        import torch
        if not torch.cuda.is_available():
            return None
    x_fmt = _FORMAT_OF_BYTES[dtype_bytes]
    w_fmt = x_fmt if weight_bytes is None else _FORMAT_OF_BYTES[weight_bytes]
    return kernel_opts_for(E, C, d, m, activation, level=level, profile=card,
                           x_dtype=x_fmt, weight_dtype=w_fmt).get("tiles")


@functools.lru_cache(maxsize=4096)
def _plan_moe_cached(B: int, S: int, d: int, E: int, de: int, top_k: int,
                     cf: float, n_mats: int, micro_cfg: int, P: int,
                     activation: str, profile: HardwareProfile,
                     dtype_bytes: int, level: str,
                     force_mode: Optional[str],
                     load: Optional[Tuple[float, ...]],
                     weight_bytes: Optional[int],
                     card: Optional["CardProfile"]) -> Plan:
    if level == "off" and force_mode is None:
        return fallback_plan(B, S, P, micro_cfg)

    feasible = feasible_modes(B, S, P)
    if force_mode is not None:
        if force_mode not in feasible:
            raise ValueError(f"mode {force_mode!r} infeasible for "
                             f"B={B} S={S} P={P} (feasible: {feasible})")
        feasible = (force_mode,)

    de_loc = max(1, de // P)
    best = None
    per_mode: Dict[str, float] = {}
    for mode in feasible:
        mode_best = None
        micro_cands = _micro_candidates(de_loc, micro_cfg) \
            if mode in ("stream", "index") else [1]
        for M in micro_cands:
            c = mode_cost(mode, B, S, d, E, de, top_k, cf, n_mats, P,
                          profile, M, dtype_bytes, load, weight_bytes)
            if mode_best is None or c["total_s"] < mode_best[0]:
                mode_best = (c["total_s"], M)
        per_mode[mode] = mode_best[0]
        if best is None or mode_best[0] < best[0]:
            best = (mode_best[0], mode, mode_best[1])
    total_s, mode, M = best

    # the winning plan's kernel shape, tiled by the Hopper planner
    T_loc = (B * S) // P if mode in ("stream", "index") else B * S
    C = _cap(max(1, T_loc), top_k, E, cf)
    m_step = max(1, de_loc // M) if mode in ("stream", "index") else de_loc
    tiles = _plan_tiles(E, C, d, m_step, activation, level, dtype_bytes,
                        weight_bytes, card)
    source = "measured" if level == "measured" else "analytic"
    return Plan(mode=mode, micro_slices=M, predicted_s=total_s,
                per_mode_s=tuple(sorted(per_mode.items())),
                source=source if force_mode is None else "forced",
                tiles=tiles)


def plan_moe(B: int, S: int, d_model: int, moe, activation: str, P: int,
             *, profile: Optional[HardwareProfile] = None,
             dtype_bytes: int = 2, level: Optional[str] = None,
             mode: Optional[str] = None,
             load: Optional[Tuple[float, ...]] = None,
             weight_bytes: Optional[int] = None,
             card: Optional["CardProfile"] = None) -> Plan:
    """Score every feasible (mode, micro_slices) and return the winner,
    as the reference does; the kernel's tile setting comes from the
    Hopper planner (``card``, else the card present; none on the CPU).

    ``moe`` is a :class:`MoEConfig`, ``P`` the model-axis size; ``mode``
    forces one mode (still optimizing the micro-slices); ``load`` prices
    a normalized per-expert load vector; ``weight_bytes`` the streamed
    expert-weight width.  Pure Python apart from the tiles; memoized."""
    level = level or autotune_level()
    profile = profile or HardwareProfile.detect()
    n_mats = 3 if activation == "swiglu" else 2
    if load is not None:
        load = tuple(float(v) for v in load)
    return _plan_moe_cached(int(B), int(S), int(d_model),
                            int(moe.num_experts), int(moe.d_expert),
                            int(moe.top_k), float(moe.capacity_factor),
                            n_mats, int(moe.micro_slices), int(P),
                            activation, profile, int(dtype_bytes), level,
                            mode, load,
                            None if weight_bytes is None else int(weight_bytes),
                            card)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# What torch's device properties do not say, by device name: the
# data-sheet device-memory bandwidth and bf16 peak (NVIDIA's H100 SXM data
# sheet), and rates of the streamed_moe kernel on the card as
# tools/fit_tile_model.py fits them (least squares in log time) to the
# device times of a path's settings at (E, d, m) = (32, 1024, 512) and C =
# 64, 1024 and 1280 (H100 80GB HBM3 at a 700 W limit).  The L2-to-SM rate
# of the tiles the blocks load and the CUDA-core phase's seconds a ring
# stage costs a block slot (its wait and barrier) were fitted on an earlier
# 12-setting bf16 mma.sync table (rms error 11.6%).  The wgmma paths
# (bf16, the 8-bit one, whose weights meet the same bf16 wgmma from
# registers, and split TF32, priced at half the rate as the data sheet's
# TF32 peak is half its bf16 one) share a rate and a stage cost, fitted on
# the bf16 path's 8 settings with that L2 rate (rms error 23.0%).
_CARDS = {
    "NVIDIA H100 80GB HBM3": dict(
        sms=132, smem_block=232448, smem_sm=233472, regs_sm=65536,
        l2_bytes=50 * 2 ** 20, mem_bw=3.35e12, bf16_peak=989e12,
        fp32_peak=67e12, l2_bw=16e12, stage_s=0.55e-6,
        wgmma_rate=750e12, wgmma_stage_s=0.12e-6),
}


@dataclass(frozen=True)
class CardProfile:
    """What the tile planner needs to know about the card (the counterpart
    of ``HardwareProfile.from_tpu`` / ``detect`` in the reference)."""

    name: str
    sms: int                   # streaming multiprocessors
    smem_block: int            # shared bytes a block may opt into
    smem_sm: int               # shared bytes an SM holds for blocks
    regs_sm: int               # 32-bit registers an SM holds
    l2_bytes: int
    mem_bw: float              # device-memory bytes/s
    bf16_peak: float           # tensor-core bf16 FLOP/s, data sheet
    fp32_peak: float           # CUDA-core fp32 FLOP/s, data sheet
    l2_bw: float               # L2-to-SM bytes/s of the tiles blocks load
    stage_s: float             # seconds a ring stage costs a CUDA-core block
    wgmma_rate: float          # bf16 wgmma FLOP/s of the kernel's paths
    wgmma_stage_s: float       # ... and their seconds a ring stage
    device: Optional[int] = None   # a card's index: read compiled resources
    regs_thread: int = 255
    threads_sm: int = 2048
    blocks_sm: int = 32
    smem_reserved: int = 1024  # shared bytes the SM keeps per block

    @classmethod
    def h100_sxm(cls) -> "CardProfile":
        """The H100 SXM's constants (no card needed)."""
        return cls(name="NVIDIA H100 80GB HBM3",
                   **_CARDS["NVIDIA H100 80GB HBM3"])

    @classmethod
    def from_device(cls, index: int = 0) -> "CardProfile":
        """Read from ``torch.cuda.get_device_properties``, with the rates
        from the table of known cards; an unknown card raises."""
        import torch
        props = torch.cuda.get_device_properties(index)
        known = _CARDS.get(props.name)
        if known is None:
            raise ValueError(f"no tile-planner profile for {props.name!r}; "
                             f"known cards: {sorted(_CARDS)}")
        read = dict(sms=props.multi_processor_count,
                    l2_bytes=props.L2_cache_size,
                    smem_block=getattr(props, "shared_memory_per_block_optin",
                                       known["smem_block"]),
                    smem_sm=props.shared_memory_per_multiprocessor,
                    regs_sm=getattr(props, "regs_per_multiprocessor",
                                    known["regs_sm"]),
                    threads_sm=props.max_threads_per_multi_processor)
        return cls(name=props.name, device=index, **{**known, **read})

    @classmethod
    def detect(cls) -> "CardProfile":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("the tile planner needs a CUDA card (or an "
                               "explicit CardProfile, e.g. h100_sxm())")
        return _detected(torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _detected(index: int) -> CardProfile:
    return CardProfile.from_device(index)


# ---------------------------------------------------------------------------
# the tile planner
# ---------------------------------------------------------------------------

# A setting replaces the default only when it is predicted at least this
# much faster: about the model's rms error (_CARDS), so closer predictions
# count as ties, which the default wins.
TIE = 0.10
# device memory moves whole 128-byte lines through L2
LINE_BYTES = 128


def _torch_dtype(name: str):
    import torch
    return {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[name]


def _path(x_dtype: str, weight_dtype: str) -> str:
    from repro_torch.kernels import streamed_moe as sm
    return sm.tile_path(_torch_dtype(x_dtype), _torch_dtype(weight_dtype))


def default_tiles(C: int, x_dtype: str = "bf16",
                  weight_dtype: str = "bf16") -> str:
    """The setting the kernel takes with no explicit tiles."""
    from repro_torch.kernels import streamed_moe as sm
    return sm.DEFAULT_TILES(C, _torch_dtype(weight_dtype),
                            _torch_dtype(x_dtype))


def _tf32_terms(x_dtype: str, weight_dtype: str):
    """The split-TF32 path's (x planes, h planes, terms up, terms down):
    an fp32 operand is two TF32 planes (one for an operand exact in TF32),
    a product one term per activation plane, plus one for fp32 weights'
    lo part."""
    xp = 2 if x_dtype == "fp32" else 1
    hp = 2 if weight_dtype == "fp32" else 1
    w_lo = 1 if weight_dtype == "fp32" else 0
    return xp, hp, xp + w_lo, hp + w_lo


def _phases(path: str, row, gated: bool, x_dtype: str, C: int = 64,
            weight_dtype: str = "fp32"):
    """Per phase (up, down) of a setting at C rows: (rows a block, columns
    a block, k-rows a stage, threads, ring shared bytes, accumulator
    registers a thread, mma passes over the activations: 3 for an operand
    taken as three bf16 planes, the split-TF32 terms on that path)."""
    from repro_torch.kernels import streamed_moe as sm
    n_up = 2 if gated else 1
    if path == "bf16":
        # wgmma: consumer warpgroups of 64 rows and a producer warp; a
        # stage is the activation tile and n weight tiles, 128-byte
        # swizzled (no padding), beside a full and an empty barrier; each
        # consumer thread keeps BN / 2 accumulators a weight matrix
        wgs, bn, bk, st = row
        bm = 64 * wgs
        return [(bm, bn, bk, 128 * wgs + 32,
                 st * (2 * bm * bk + n * 2 * bk * bn + 16) + 1024,
                 n * bn // 2, 1) for n in (n_up, 1)]
    if path == "8bit":
        # wgmma with the weights in registers: consumer warpgroups of 64
        # weight columns, no producer warp; a block's rows are the C tile;
        # a stage is the activation planes' tiles (128-byte swizzled) and n
        # raw 8-bit weight tiles, beside a full and an empty barrier; each
        # thread keeps a partial and a promoted sum of C_tile / 2 a matrix
        bm = sm.q_c_tile(C, _torch_dtype(x_dtype))
        out = []
        for (wgs, bk, st), n, parts in ((row[0], n_up, 3 if x_dtype == "fp32"
                                         else 1), (row[1], 1, 3)):
            bn = sm.Q_WG_COLS * wgs
            smem = st * (parts * bk * bm * 2 + n * bk * bn + 16) + 1024
            out.append((bm, bn, bk, 128 * wgs, smem, n * bm, parts))
        return out
    # split TF32: as the 8-bit path, the C tile (C rounded up to 16, at most
    # 64) for any x; a stage is the activation planes' fp32 tiles and n
    # weight tiles of their own type
    bm = sm.q_c_tile(C)
    wb = WEIGHT_DTYPES[weight_dtype]
    xp, hp, terms_up, terms_down = _tf32_terms(x_dtype, weight_dtype)
    out = []
    for (wgs, bk, st), n, planes, terms in ((row[0], n_up, xp, terms_up),
                                            (row[1], 1, hp, terms_down)):
        bn = sm.Q_WG_COLS * wgs
        smem = st * (planes * bk * bm * 4 + n * bk * bn * wb + 16) + 1024
        out.append((bm, bn, bk, 128 * wgs, smem, n * bm, terms))
    if weight_dtype == "bf16":
        # phase 1 on CUDA cores: 64 x 64 tiles of 256 threads, 32 k-rows a
        # step in two fp32 buffers (x transposed, rows padded by 4), 4 x 4
        # sums a thread a weight matrix
        out[0] = (64, 64, 32, 256, 4 * (2 * 32 * 68 + 2 * n_up * 32 * 64),
                  16 * n_up, 1)
    return out


@functools.lru_cache(maxsize=None)
def _compiled(tiles: str, x_dtype: str, weight_dtype: str, C: int):
    """The compiled resources of a setting's kernels on the card at C
    rows (``kernels.streamed_moe.tile_attrs``), read once."""
    from repro_torch.kernels import streamed_moe as sm
    return sm.tile_attrs(tiles, _torch_dtype(x_dtype),
                         _torch_dtype(weight_dtype), C)


def _estimated_regs(acc: int, a_regs: int) -> int:
    """Registers a thread on the CPU: the accumulators, the A fragments
    held in registers (``a_regs``: 0 where wgmma reads A from shared
    memory) and about 40 for addresses, B fragments and the loop."""
    return acc + a_regs + 40


def blocks_per_sm(profile: CardProfile, threads: int, smem: int,
                  regs: int) -> int:
    """Blocks an SM holds, from its threads, shared memory and registers
    (allocated a warp at a time, in units of 256)."""
    warp_regs = -(-regs * 32 // 256) * 256
    by_regs = profile.regs_sm // (warp_regs * (threads // 32))
    by_smem = profile.smem_sm // (smem + profile.smem_reserved)
    return max(0, min(profile.threads_sm // threads, by_smem, by_regs,
                      profile.blocks_sm))


def tile_cost(E: int, C: int, d: int, m: int, activation: str, tiles: str,
              profile: CardProfile, x_dtype: str = "bf16",
              weight_dtype: str = "bf16") -> Dict[str, object]:
    """The predicted seconds of one ``streamed_moe`` call with setting
    ``tiles``, and whether it fits the card.

    Per phase, the larger of two times.  Compute: the tensor-core work
    (padded rows and columns, each mma pass or split-TF32 term counted)
    over ``profile.wgmma_rate`` (half of it for TF32), plus the tiles
    every block loads into shared memory over ``profile.l2_bw`` (smaller
    blocks re-read more), plus ``profile.wgmma_stage_s`` for each ring
    stage a block slot runs (for the CUDA-core phase 1 of bf16 weights
    with fp32 x, ``profile.fp32_peak`` and ``profile.stage_s``); times the waves of blocks the grid needs (the
    tail wave counted whole) over the waves it fills, a wave being the SMs
    times the blocks an SM holds, or times ceil(blocks / SMs) when that is
    fewer.  Memory: the device-memory bytes over ``profile.mem_bw``, the
    weight stream's at the share of a 128-byte line that a block's row of
    a weight tile covers (a block reads BN columns of each weight row);
    weights count once per expert when all its blocks fit on the card at
    once (its row tiles then share them through L2), else once per row
    tile, and x, h and out as the phases move them."""
    from repro_torch.kernels import streamed_moe as sm
    path = _path(x_dtype, weight_dtype)
    row = sm.TILE_SETTINGS[path].get(tiles)
    if row is None:
        raise ValueError(f"unknown streamed_moe tile setting {tiles!r} for "
                         f"the {path} path; known: "
                         f"{list(sm.TILE_SETTINGS[path])}")
    gated = activation == "swiglu"
    wb = WEIGHT_DTYPES[weight_dtype]
    xb = WEIGHT_DTYPES[x_dtype]
    xp, hp, _, _ = _tf32_terms(x_dtype, weight_dtype)
    # h as the kernel keeps it, and a shared activation element (bytes) by
    # the planes a stage holds
    hb = {"bf16": 2, "8bit": 6, "tf32": 4 * hp}[path]
    ab = {"bf16": (2, 2), "8bit": (2, 2),
          "tf32": (4 if weight_dtype == "bf16" else 4 * xp, 4 * hp)}[path]
    compiled = None if profile.device is None else \
        _compiled(tiles, x_dtype, weight_dtype, C)
    attr_key = ("up_swiglu" if gated else f"up_{activation}", "down")
    # phase 1 of bf16 weights with fp32 x runs on CUDA cores
    core_up = path == "tf32" and weight_dtype == "bf16"
    phases = []
    # (contraction, columns, weight matrices, bytes in besides weights,
    # bytes out)
    x_in = E * C * d * xb
    if path == "8bit" and x_dtype == "fp32":
        x_in += E * C * d * (4 + 6)
    elif path == "tf32" and not core_up:   # x's second plane written, read
        x_in += E * C * d * 4 * (1 + xp)
    shapes = ((d, m, 2 if gated else 1, x_in, E * C * m * hb),
              (m, d, 1, E * C * m * hb, E * C * d * 4))
    for (bm, bn, bk, threads, smem, acc, parts), key, a_bytes, \
            (K, N, n_w, b_in, b_out) in zip(
                _phases(path, row, gated, x_dtype, C, weight_dtype),
                attr_key, ab, shapes):
        core = core_up and key != "down"
        # the split-TF32 terms run at the TF32 rate, half the bf16 one
        # (data sheet: 495 and 989 TFLOP/s), CUDA-core FMAs at the fp32 one
        rate = profile.fp32_peak if core else profile.wgmma_rate / 2 \
            if path == "tf32" else profile.wgmma_rate
        stage_s = profile.stage_s if core else profile.wgmma_stage_s
        # A fragments in registers: two buffers of a weight matrix's 4 (8
        # with an fp32 weight's hi and lo parts); a CUDA-core thread's 16
        a_regs = 16 if core else {
            "bf16": 0, "8bit": 8 * n_w,
            "tf32": (16 if weight_dtype == "fp32" else 8) * n_w}[path]
        if compiled is None:
            regs, spill = _estimated_regs(acc, a_regs), 0
        else:
            regs, spill = compiled[key]["regs"], compiled[key]["spill_bytes"]
        row_tiles, col_tiles = -(-C // bm), -(-N // bn)
        blocks = row_tiles * col_tiles * E
        per_sm = blocks_per_sm(profile, threads, smem, regs)
        fits = (smem <= profile.smem_block and regs <= profile.regs_thread
                and spill == 0 and per_sm > 0)
        # the slots the grid can fill: a grid of fewer blocks than slots
        # puts at most ceil(blocks / SMs) on an SM
        slots = profile.sms * max(1, min(per_sm, -(-blocks // profile.sms)))
        filled = blocks / slots
        ops = 2.0 * E * row_tiles * bm * K * col_tiles * bn * n_w * parts
        planes = 1 if path == "tf32" else parts
        loaded = blocks * K * (bm * a_bytes * planes + n_w * bn * wb)
        stages = blocks * -(-K // bk) / slots
        t_ops = (ops / rate + loaded / profile.l2_bw
                 + stages * stage_s) * math.ceil(filled) / filled
        together = row_tiles * col_tiles <= slots
        weights = n_w * K * N * wb * E * (1 if together else row_tiles)
        moved = weights / min(1.0, bn * wb / LINE_BYTES) + b_in + b_out
        if path == "8bit":
            moved += 4 * E * N * n_w                    # scales
        t_bytes = moved / profile.mem_bw
        phases.append(dict(t=max(t_ops, t_bytes), t_ops=t_ops,
                           t_bytes=t_bytes, fits=fits, regs=regs,
                           spill=spill, smem=smem, threads=threads,
                           blocks=blocks, blocks_per_sm=per_sm,
                           waves=filled))
    return {"t": sum(p["t"] for p in phases),
            "fits": all(p["fits"] for p in phases), "phases": phases}


def plan_kernel_tiles(E: int, C: int, d: int, m: int, activation: str,
                      profile: Optional[CardProfile] = None,
                      x_dtype: str = "bf16",
                      weight_dtype: str = "bf16") -> Dict[str, object]:
    """Score every setting of the call's path and return the winner with
    its predicted seconds, the default's, and every fitting candidate by
    predicted time.  The default setting is always a candidate and wins
    ties (within ``TIE``); the other settings that do not fit (shared
    memory, registers, spills) are not candidates, and a default that
    does not fit loses to any that does."""
    from repro_torch.kernels import streamed_moe as sm
    profile = profile or CardProfile.detect()
    default = default_tiles(C, x_dtype, weight_dtype)
    scored = {}
    for name in sm.TILE_SETTINGS[_path(x_dtype, weight_dtype)]:
        sc = tile_cost(E, C, d, m, activation, name, profile, x_dtype,
                       weight_dtype)
        if sc["fits"] or name == default:
            scored[name] = sc
    # fitting settings first; a default that does not fit loses to any
    # that does
    ranked = sorted(scored, key=lambda n: (not scored[n]["fits"],
                                           scored[n]["t"], n != default))
    best = ranked[0]
    if scored[default]["fits"] and \
            scored[best]["t"] > (1.0 - TIE) * scored[default]["t"]:
        best = default
    return {"tiles": best, "default": default,
            "predicted_s": scored[best]["t"],
            "default_s": scored[default]["t"], "fits": scored[best]["fits"],
            "ranked": [(name, scored[name]["t"]) for name in ranked]}


# ---------------------------------------------------------------------------
# measured tiles (cached on disk)
# ---------------------------------------------------------------------------

# the measured level times the default, the analytic pick and this many
# more of the planner's ranking
NEIGHBOURS = 3
# candidates timed, so a run can show a cache hit timed nothing; and the
# kernel launches the timing made (each counted by the kernel's wrapper too)
TIMINGS = 0
TIMING_LAUNCHES = 0
_MEASURED: Dict[str, dict] = {}
_CACHE_LOADED = False
CACHE_FILE = "kernel_tiles_torch.json"   # the reference's is kernel_tiles.json


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def cache_dir() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE",
                          os.path.join(_repo_root(), "artifacts", "autotune"))


def _cache_path() -> str:
    return os.path.join(cache_dir(), CACHE_FILE)


def _load_cache() -> None:
    global _CACHE_LOADED
    if _CACHE_LOADED:
        return
    _CACHE_LOADED = True
    try:
        with open(_cache_path()) as f:
            _MEASURED.update(json.load(f))
    except (OSError, ValueError):
        pass


def _save_cache() -> None:
    os.makedirs(cache_dir(), exist_ok=True)
    with open(_cache_path(), "w") as f:
        json.dump(_MEASURED, f, indent=1, sort_keys=True)


def forget_measured() -> None:
    """Drop the in-memory measured tiles, so the next lookup reads the
    disk cache again."""
    global _CACHE_LOADED
    _MEASURED.clear()
    _CACHE_LOADED = False
    _kernel_opts_cached.cache_clear()


def _kernel_hash() -> str:
    from repro_torch.kernels import build
    return build.source_hash("streamed_moe")


def _device_key() -> str:
    import torch
    return (f"{torch.cuda.get_device_name()}/torch{torch.__version__}/"
            f"cuda{torch.version.cuda}")


def measured_key(E: int, C: int, d: int, m: int, activation: str,
                 x_dtype: str, weight_dtype: str) -> str:
    """The card, the torch and CUDA versions, the kernel source's hash and
    the call's shape: a stale entry never picks tiles by another kernel's
    times."""
    return (f"{_device_key()}/src{_kernel_hash()}/E{E}_C{C}_d{d}_m{m}_"
            f"{activation}_x{x_dtype}_w{weight_dtype}")


def _time_setting(E: int, C: int, d: int, m: int, activation: str,
                  x_dtype: str, weight_dtype: str, tiles: str,
                  reps: int) -> float:
    """Milliseconds of device time of one call with setting ``tiles``, on
    random operands made on the card from seed 0: CUDA events around
    ``reps`` calls after three warm-up calls."""
    global TIMING_LAUNCHES
    import torch
    from repro_torch.kernels import quant
    from repro_torch.kernels import streamed_moe as sm
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(generator=gen, device="cuda")
    xe = torch.randn(E, C, d, **kw).to(_torch_dtype(x_dtype))
    ws = [torch.randn(E, *s, **kw) / s[0] ** 0.5
          for s in ((d, m), (d, m), (m, d))]
    if not activation == "swiglu":
        ws[0] = None
    scales = {}
    if weight_dtype in quant.QUANTIZED:
        qs = [quant.quantize(w, weight_dtype) if w is not None else (None, None)
              for w in ws]
        ws = [q for q, _ in qs]
        scales = dict(zip(("s_g", "s_u", "s_d"), (s for _, s in qs)))
    else:
        ws = [quant.storage_cast(w, weight_dtype) for w in ws]

    def call():
        return sm.streamed_moe_kernel(xe, *ws, activation=activation,
                                      tiles=tiles, **scales)
    TIMING_LAUNCHES += 3 + reps
    for _ in range(3):
        call()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def measured_kernel_tiles(E: int, C: int, d: int, m: int, activation: str,
                          x_dtype: str = "bf16", weight_dtype: str = "bf16",
                          reps: int = 20,
                          profile: Optional[CardProfile] = None) -> dict:
    """Time the default setting, the analytic pick and the next
    ``NEIGHBOURS`` settings of the planner's ranking once, and keep the
    fastest, in memory and on disk (``kernel_tiles_torch.json`` under
    ``cache_dir()``), keyed by :func:`measured_key`.  Never times inside a
    CUDA graph capture: a key that is not cached then raises."""
    global TIMINGS
    import torch
    _load_cache()
    key = measured_key(E, C, d, m, activation, x_dtype, weight_dtype)
    if key in _MEASURED:
        return _MEASURED[key]
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"measured tiles for {key} are not cached, and "
                           f"nothing is timed inside a CUDA graph capture: "
                           f"run the call once eagerly first")
    plan = plan_kernel_tiles(E, C, d, m, activation, profile, x_dtype,
                             weight_dtype)
    cands = [plan["default"]]
    for name, _ in plan["ranked"]:
        if name not in cands and len(cands) < NEIGHBOURS + 2:
            cands.append(name)
    rows = []
    for name in cands:
        ms = _time_setting(E, C, d, m, activation, x_dtype, weight_dtype,
                           name, reps)
        TIMINGS += 1
        rows.append({"tiles": name, "ms": ms})
    best = min(rows, key=lambda r: r["ms"])
    entry = {"tiles": best["tiles"], "ms": best["ms"],
             "analytic": plan["tiles"], "analytic_s": plan["predicted_s"],
             "candidates": rows}
    _MEASURED[key] = entry
    _save_cache()
    return entry


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _kernel_opts_cached(E: int, C: int, d: int, m: int, activation: str,
                        x_dtype: str, weight_dtype: str, level: str,
                        profile: Optional[CardProfile]
                        ) -> Tuple[Tuple[str, str], ...]:
    if level == "off":
        return ()
    if level == "measured":
        entry = measured_kernel_tiles(E, C, d, m, activation, x_dtype,
                                      weight_dtype, profile=profile)
        return (("tiles", entry["tiles"]),)
    plan = plan_kernel_tiles(E, C, d, m, activation, profile, x_dtype,
                             weight_dtype)
    return (("tiles", plan["tiles"]),)


def kernel_opts_for(E: int, C: int, d: int, m: int, activation: str, *,
                    level: Optional[str] = None,
                    profile: Optional[CardProfile] = None,
                    x_dtype: str = "bf16",
                    weight_dtype: str = "bf16") -> Dict[str, str]:
    """Tile kwargs (``{"tiles": name}``) for one ``streamed_moe`` call
    shape under the ambient (or given) autotune level; ``{}`` at level
    'off', the kernel's default.  The formats of the activations and the
    streamed weights ('fp32', 'bf16', 'int8', 'fp8') pick the kernel path
    whose settings are planned."""
    level = level or autotune_level()
    if level not in LEVELS:
        raise ValueError(f"unknown autotune level {level!r}")
    if level == "off":
        return {}
    return dict(_kernel_opts_cached(
        int(E), int(C), int(d), int(m), activation, x_dtype, weight_dtype,
        level, profile or CardProfile.detect()))

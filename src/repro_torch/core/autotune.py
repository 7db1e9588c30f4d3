"""The autotune level, the Hopper tile planner of ``streamed_moe`` and the
serving engine's modeled chiplet clock (port of ``repro.core.autotune``
but for the distributed planner).

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
``Plan.kernel_opts`` would).  The distributed planner (``plan_moe``,
``mode_cost``, ``ep_cost``) waits for ROADMAP A.14.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import moe_capacity_rows
from repro_torch.kernels.quant import WEIGHT_DTYPES

LEVELS = ("off", "analytic", "measured")
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
    discrete referee; the reference asserts their rank agreement across
    families, which needs ``family_costs``, ROADMAP A.14).

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
# the card
# ---------------------------------------------------------------------------

# What torch's device properties do not say, by device name: the
# data-sheet device-memory bandwidth and bf16 / fp32 peaks (NVIDIA's H100
# SXM data sheet), and three rates of the streamed_moe kernel on the card
# as tools/fit_tile_model.py fits them (least squares in log time) to the
# device times of its 12 bf16 settings at (E, d, m) = (32, 1024, 512) and
# C = 64, 1024 and 1280 (H100 80GB HBM3 at a 700 W limit): the mma.sync
# rate, the L2-to-SM rate of the tiles the blocks load, and the seconds a
# ring stage costs a block slot (its wait and barrier).  The fit's rms
# error is 11.6%.
_CARDS = {
    "NVIDIA H100 80GB HBM3": dict(
        sms=132, smem_block=232448, smem_sm=233472, regs_sm=65536,
        l2_bytes=50 * 2 ** 20, mem_bw=3.35e12, bf16_peak=989e12,
        fp32_peak=67e12, mma_rate=450e12, l2_bw=16e12, stage_s=0.55e-6),
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
    mma_rate: float            # bf16 mma.sync FLOP/s the kernel reaches
    l2_bw: float               # L2-to-SM bytes/s of the tiles blocks load
    stage_s: float             # seconds a ring stage costs a block slot
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


def _phases(path: str, row, gated: bool, x_dtype: str):
    """Per phase (up, down) of a setting: (rows a block, columns a block,
    k-rows a stage, threads, ring shared bytes, accumulator registers a
    thread, mma passes over the activations: 3 for an operand taken as
    three bf16 planes)."""
    from repro_torch.kernels import streamed_moe as sm
    n_up = 2 if gated else 1
    if path == "bf16":
        bm, bn, wm, wn, bk, st = row
        threads = 32 * (bm // wm) * (bn // wn)
        return [(bm, bn, bk, threads,
                 2 * st * (bm * (bk + 8) + n * bk * (bn + 8)),
                 n * wm * wn // 32, 1) for n in (n_up, 1)]
    if path == "8bit":
        bm = sm.Q_ROWS_A_BLOCK
        parts_x = 3 if x_dtype == "fp32" else 1
        out = []
        for (bn, wn, bk, st), n, parts in ((row[0], n_up, parts_x),
                                           (row[1], 1, 3)):
            smem = st * (parts * bm * (bk + 8) * 2 + n * bk * (bn + 16))
            acc = (2 if parts > 1 else 1) * n * 4 * (wn // 8) * 4
            out.append((bm, bn, bk, 32 * bn // wn, smem, acc, parts))
        return out
    bm, bn, bk = row
    return [(bm, bn, bk, 256, 4 * (2 * bk * (bm + 4) + 2 * n * bk * bn),
             16 * n, 1) for n in (n_up, 1)]


@functools.lru_cache(maxsize=None)
def _compiled(tiles: str, x_dtype: str, weight_dtype: str):
    """The compiled resources of a setting's kernels on the card
    (``kernels.streamed_moe.tile_attrs``), read once."""
    from repro_torch.kernels import streamed_moe as sm
    return sm.tile_attrs(tiles, _torch_dtype(x_dtype),
                         _torch_dtype(weight_dtype))


def _estimated_regs(acc: int, parts: int) -> int:
    """Registers a thread on the CPU: the accumulators, the A fragments
    (four a 16-row tile and plane) and about 40 for addresses, B
    fragments and the loop."""
    return acc + 16 * parts + 40


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
    (padded rows and columns, each mma pass counted) over
    ``profile.mma_rate`` (the fp32 peak on the CUDA-core path), plus the
    tiles every block loads into shared memory over ``profile.l2_bw``
    (smaller blocks re-read more), plus ``profile.stage_s`` for each ring
    stage a block slot runs; times the waves of blocks the grid needs (the
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
    hb = {"bf16": 2, "8bit": 6, "simt": 4}[path]       # h as the kernel keeps it
    ab = 4 if path == "simt" else 2                    # a shared activation element
    compiled = None if profile.device is None else \
        _compiled(tiles, x_dtype, weight_dtype)
    attr_key = ("up_swiglu" if gated else f"up_{activation}", "down")
    rate = profile.fp32_peak if path == "simt" else profile.mma_rate
    phases = []
    # (contraction, columns, weight matrices, bytes in besides weights,
    # bytes out)
    x_in = E * C * d * xb + (E * C * d * (4 + 6) if path == "8bit"
                             and x_dtype == "fp32" else 0)
    shapes = ((d, m, 2 if gated else 1, x_in, E * C * m * hb),
              (m, d, 1, E * C * m * hb, E * C * d * 4))
    for (bm, bn, bk, threads, smem, acc, parts), key, \
            (K, N, n_w, b_in, b_out) in zip(
                _phases(path, row, gated, x_dtype), attr_key, shapes):
        if compiled is None:
            regs, spill = _estimated_regs(acc, parts), 0
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
        loaded = blocks * K * (bm * ab * parts + n_w * bn * wb)
        stages = blocks * -(-K // bk) / slots
        t_ops = (ops / rate + loaded / profile.l2_bw
                 + stages * profile.stage_s) * math.ceil(filled) / filled
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

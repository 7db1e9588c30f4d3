"""The serving engine's modeled chiplet clock (port of the cost-model part
of ``repro.core.autotune``).

:class:`ServingCostModel` turns each workload-trace record (observed
per-expert counts and the schedule policy) into closed-form seconds of
the paper's chiplet array: DDR streams expert weights in trajectory order
while the array computes the expert loaded before (double-buffered).  The
profile is pure Table-I constants (:mod:`repro_torch.sim.hardware`), so
the modeled TTFT / TPOT are the same on every machine; they describe the
modeled array, never the card the port runs on.

The two-tier ``hybrid`` pricing waits for ROADMAP A.11b and the kernel
tile planner (``plan_moe``, tiles, measured timing) for A.12.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import moe_capacity_rows


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
        ``resident`` experts skip their DDR stream.  The two-tier
        ``hot`` pricing is not ported yet."""
        if hot is not None:
            raise NotImplementedError(
                "two-tier hybrid pricing is not ported yet: ROADMAP A.11b "
                "(hybrid, resident tier)")
        total = float(sum(float(c) for c in counts))
        tokens = max(1, math.ceil(total / max(1, self.top_k)))
        C = _cap(tokens, self.top_k, self.num_experts, self.capacity_factor)
        load = None
        if dynamic and total > 0:
            load = tuple(float(c) / total for c in counts)
        return streaming_layer_cost(
            self.num_experts, C, self.d_model, self.d_expert, self.n_mats,
            total, self.profile, dtype_bytes=self.dtype_bytes,
            weight_bytes=self.weight_bytes, resident=resident,
            load=load)["total_s"]

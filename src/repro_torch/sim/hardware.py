"""Chiplet-array hardware model, paper Table I (port of
``repro.sim.hardware``).

All constants default to the paper's taped-out 2x2 5nm MCM prototype:
DDR3-1600 4x25.6 GB/s, UCIe D2D 288 GB/s per chiplet, 2048-MAC compute
dies at 800 MHz (4.865 TOPS), FDI-to-FDI latency about 4 ns a hop.  They
describe the modeled chiplet array, never the card the port runs on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class NDPConfig:
    """Optional near-memory compute tier (NDP/PIM dies beside the DRAM
    stacks), as tier totals: a pool of weak MACs on wide local DRAM ports.
    Defaults follow the HD-MoE / GPU-NDP operating point: about 1/16 of
    the 2x2 array's compute, about 4x its external DDR bandwidth."""
    tops: float = 1.2e12              # tier-total near-memory ops/s
    gbps: float = 409.6e9             # tier-total local DRAM bytes/s
    buffer_bytes: int = 2 * 2 ** 20   # per-tier staging SRAM


@dataclass(frozen=True)
class HardwareConfig:
    rows: int = 2
    cols: int = 2
    tops: float = 4.865e12            # per-die peak ops/s
    d2d_gbps: float = 288e9           # per-chiplet D2D bandwidth (bytes/s)
    d2d_hop_latency: float = 4.02e-9  # FDI-to-FDI (s/hop)
    ddr_channels: int = 4
    ddr_gbps_per_channel: float = 25.6e9
    buffer_bytes: int = 8 * 2 ** 20   # per-die SRAM for expert weights
    bytes_per_param: int = 2          # bf16 weights
    bytes_per_act: int = 2
    freq_hz: float = 800e6
    ndp: Optional[NDPConfig] = None   # near-memory tier (None = homogeneous)

    @property
    def num_chiplets(self) -> int:
        return self.rows * self.cols

    @property
    def ddr_total(self) -> float:
        return self.ddr_channels * self.ddr_gbps_per_channel

    def hops(self, a: int, b: int) -> int:
        """Manhattan distance on the 2D mesh."""
        ra, ca = divmod(a, self.cols)
        rb, cb = divmod(b, self.cols)
        return abs(ra - rb) + abs(ca - cb)


# paper Table I prototype
PROTOTYPE_2X2 = HardwareConfig()


def with_ndp(base: HardwareConfig = PROTOTYPE_2X2,
             ndp: Optional[NDPConfig] = None) -> HardwareConfig:
    """The heterogeneous variant of an array: same chiplets + DDR, plus a
    near-memory tier.  The NDP defaults scale with the base array's DDR
    bandwidth (local ports are ~4x the external channels)."""
    if ndp is None:
        ndp = NDPConfig(gbps=4.0 * base.ddr_total)
    return dataclasses.replace(base, ndp=ndp)


# the prototype with the default near-memory tier attached
PROTOTYPE_2X2_NDP = with_ndp()


def scaled(rows: int, cols: int, base: HardwareConfig = PROTOTYPE_2X2) -> HardwareConfig:
    """Scale the array (DDR channels grow with the array *edge*, as in
    §VI-E — ``max(rows, cols)``, so a 2x4 and a 4x2 array get the same
    DDR and odd edges still scale).  A base NDP tier's local bandwidth
    grows with the DDR it sits beside."""
    channels = base.ddr_channels * max(2, max(rows, cols)) // 2
    out = dataclasses.replace(base, rows=rows, cols=cols,
                              ddr_channels=channels)
    if base.ndp is not None:
        ratio = channels / max(1, base.ddr_channels)
        out = dataclasses.replace(out, ndp=dataclasses.replace(
            base.ndp, gbps=base.ndp.gbps * ratio))
    return out


@dataclass(frozen=True)
class ModelSpec:
    """What the simulator needs to know about one MoE layer."""
    name: str
    d_model: int
    d_expert: int
    num_experts: int
    top_k: int
    n_mats: int = 3                   # swiglu: gate+up+down
    num_layers: int = 1
    d_ff_dense: int = 0               # attention-adjacent dense FFN (e2e only)
    num_heads: int = 16
    num_shared: int = 0
    bytes_per_param: Optional[int] = None  # streamed expert-weight bytes;
    #   None = the hardware default (bf16).  1 models int8/fp8 streaming.

    def expert_bytes_on(self, hw: HardwareConfig) -> int:
        """Streamed DDR bytes of one expert's weights on ``hw`` — a
        ``None`` ``bytes_per_param`` falls back to the *hardware*
        default, so a 4-byte hardware profile streams 4-byte weights."""
        return self.n_mats * self.d_model * self.d_expert \
            * (self.bytes_per_param or hw.bytes_per_param)

    @property
    def expert_bytes(self) -> int:
        """Hardware-free view: resolves a ``None`` ``bytes_per_param``
        against the Table-I prototype's default.  Call sites that know
        their :class:`HardwareConfig` use :meth:`expert_bytes_on`."""
        return self.expert_bytes_on(PROTOTYPE_2X2)

    def expert_flops_per_token(self) -> float:
        return 2.0 * self.n_mats * self.d_model * self.d_expert


def spec_from_config(cfg, weight_bytes: Optional[int] = None, *,
                     hw: Optional[HardwareConfig] = None) -> ModelSpec:
    """Build a sim spec from a ModelConfig (must have MoE).

    ``weight_bytes`` overrides the streamed expert-weight storage width
    (e.g. 1 for an int8/fp8 ``ExecutionSpec.weight_dtype`` run) so the
    simulator referee and the closed-form cost model agree on DDR bytes.
    With ``weight_bytes=None``, ``hw`` pins the spec's weight width to
    that hardware's ``bytes_per_param`` (otherwise it stays ``None`` and
    resolves per call site via :meth:`ModelSpec.expert_bytes_on`).
    """
    assert cfg.moe is not None
    if weight_bytes is None and hw is not None:
        weight_bytes = hw.bytes_per_param
    return ModelSpec(
        name=cfg.name, d_model=cfg.d_model, d_expert=cfg.moe.d_expert,
        num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        n_mats=3 if cfg.activation == "swiglu" else 2,
        num_layers=cfg.num_layers, d_ff_dense=cfg.d_ff,
        num_heads=max(1, cfg.num_heads), num_shared=cfg.moe.num_shared_experts,
        bytes_per_param=weight_bytes)


# paper Table I models for the simulator benchmarks
PAPER_SPECS = {
    "phi3.5-moe": ModelSpec("phi3.5-moe", 4096, 3200, 16, 2, 3, 32, 3200, 32),  # Table-I d_ffn
    "yuan2-m32": ModelSpec("yuan2-m32", 2048, 4096, 32, 2, 3, 24, 4096, 16),
    "deepseek-moe": ModelSpec("deepseek-moe", 2048, 1408, 64, 6, 3, 28, 1408, 16, 2),
    "qwen3-a3b": ModelSpec("qwen3-a3b", 2048, 768, 128, 8, 3, 48, 768, 32),
}

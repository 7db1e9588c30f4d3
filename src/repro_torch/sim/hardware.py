"""Chiplet-array hardware model, paper Table I (port of the constants of
``repro.sim.hardware`` that the modeled serving clock reads).

All constants default to the paper's taped-out 2x2 5nm MCM prototype:
DDR3-1600 4x25.6 GB/s, UCIe D2D 288 GB/s per chiplet, 2048-MAC compute
dies at 800 MHz (4.865 TOPS), FDI-to-FDI latency about 4 ns a hop.  They
describe the modeled chiplet array, never the card the port runs on.
"""
from __future__ import annotations

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

"""Paper-reproduction demo on the port: the chiplet simulator across all
four Table-I models, printing the headline claims (speedup band and memory
saving), like a miniature of the paper's section VI.

The simulator is numpy on the host, as the reference's; the device (``cuda``
unless ``--device cpu`` is given, and asking for ``cuda`` where there is
none raises) is only where the port's runs would go.

  PYTHONPATH=src python examples/expert_streaming_sim_torch.py
  PYTHONPATH=src python examples/expert_streaming_sim_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.sim import (PAPER_SPECS, PROTOTYPE_2X2, iteration_workloads,
                             simulate_layer)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    hw = PROTOTYPE_2X2
    print(f"array: {hw.rows}x{hw.cols} chiplets, {hw.tops/1e12:.2f} TOPS/die, "
          f"D2D {hw.d2d_gbps/1e9:.0f} GB/s, DDR {hw.ddr_total/1e9:.1f} GB/s, "
          f"{hw.buffer_bytes/2**20:.0f} MB SRAM/die\n")
    speedups, savings = [], []
    print(f"{'model':14s}{'tokens':>7s}{'EP (us)':>10s}{'FSE-DP (us)':>12s}"
          f"{'speedup':>9s}{'EP mem':>9s}{'FSE mem':>9s}{'saving':>8s}")
    for mname, spec in PAPER_SPECS.items():
        for toks in (16, 64, 256):
            l_ep, l_fse, m_ep, m_fse = [], [], [], []
            for seed in range(3):
                wl = iteration_workloads(spec, tokens_per_iter=toks,
                                         num_chiplets=hw.num_chiplets,
                                         seed=seed)[0]
                rep = simulate_layer(hw, spec, wl, "ep")
                rfs = simulate_layer(hw, spec, wl, "fse_dp_paired")
                l_ep.append(rep.latency)
                l_fse.append(rfs.latency)
                m_ep.append(rep.peak_buffer_bytes)
                m_fse.append(rfs.peak_buffer_bytes)
            sp = np.mean(l_ep) / np.mean(l_fse)
            sv = 1 - np.mean(m_fse) / np.mean(m_ep)
            speedups.append(sp)
            savings.append(sv)
            print(f"{mname:14s}{toks:>7d}{np.mean(l_ep)*1e6:>10.0f}"
                  f"{np.mean(l_fse)*1e6:>12.0f}{sp:>8.2f}x"
                  f"{np.mean(m_ep)/2**20:>8.0f}M{np.mean(m_fse)/2**20:>8.0f}M"
                  f"{100*sv:>7.1f}%")
    print(f"\nspeedup over EP: {min(speedups):.2f}x .. {max(speedups):.2f}x "
          f"(paper: 1.22-2.00x vs its baselines)")
    print(f"on-chip memory saving: up to {100*max(savings):.1f}% "
          f"(paper: up to 78.8%)")
    return {"speedups": speedups, "savings": savings}


if __name__ == "__main__":
    main()

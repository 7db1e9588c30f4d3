#!/usr/bin/env python3
"""Fit the tile planner's rates of the bf16 path to the streamed_moe
kernel's device times, on one GPU.

    python3 tools/fit_tile_model.py

Times every bf16 setting of ``TILE_SETTINGS`` at granite width (E, d, m)
= (32, 1024, 512), swiglu, C = 64, 1024 and 1280 (``chip_smoke.device_ms``),
then searches a grid for the ``wgmma_rate`` and ``wgmma_stage_s`` of
``core.autotune.CardProfile`` (``l2_bw`` kept) that minimise the squared
log error of ``core.autotune.tile_cost`` (with the compiled kernels'
registers) against those times.  It prints the fitted rates, the rms
error, and each setting's time beside its prediction.  The rates in
``core.autotune._CARDS`` are this script's output; the 8-bit and
split-TF32 paths are priced with the same two (the latter at half the
rate; ``l2_bw`` and the CUDA-core phase's ``stage_s`` are not refitted
here).
"""
import dataclasses
import itertools
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import streamed_moe as sm  # noqa: E402

E, D, M, ACT = 32, 1024, 512, "swiglu"
CS = (64, 1024, 1280)
GRID = dict(wgmma_rate=[r * 1e12 for r in range(300, 990, 25)],
            wgmma_stage_s=[c * 1e-8 for c in range(2, 121, 2)])


def main():
    cs.phase_env()
    build.build_all(["streamed_moe"])
    profile = autotune.CardProfile.detect()
    times = {}
    for C in CS:
        xe, wg, wu, wd = cs._moe_inputs(E, C, D, M, ACT, torch.bfloat16)
        ws, _ = cs._stream_operands(wg, wu, wd, "bf16")
        for name in sm.TILE_SETTINGS["bf16"]:
            times[C, name] = cs.device_ms(lambda: sm.streamed_moe_kernel(
                xe, *ws, activation=ACT, tiles=name))[0] * 1e-3

    def loss(p):
        return sum(math.log(autotune.tile_cost(E, C, D, M, ACT, name, p)["t"]
                            / t) ** 2 for (C, name), t in times.items())
    best = min((loss(p), p) for p in (
        dataclasses.replace(profile, **dict(zip(GRID, values)))
        for values in itertools.product(*GRID.values())))
    err, p = best
    print(f"fitted on {profile.name}: wgmma_rate {p.wgmma_rate:.4g}, "
          f"wgmma_stage_s {p.wgmma_stage_s:.4g}; rms log error "
          f"{math.sqrt(err / len(times)):.4f} over {len(times)} times",
          flush=True)
    for (C, name), t in times.items():
        pred = autotune.tile_cost(E, C, D, M, ACT, name, p)["t"]
        print(f"C={C} {name}: device {t * 1e3:.4f} ms, fitted "
              f"{pred * 1e3:.4f} ms", flush=True)


if __name__ == "__main__":
    main()

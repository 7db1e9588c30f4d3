"""Quickstart on the PyTorch + CUDA port: the paper's idea in a minute.

1. micro-slice order invariance through the ``streamed_moe`` kernel: the
   sum over d_expert micro-slices, taken in a random order, equals the
   whole expert;
2. FSE-DP on ``--ranks`` gloo ranks (``parallel.localrun``) == the dense
   oracle;
3. one chiplet-simulator comparison (FSE-DP vs EP latency and memory).

It runs on ``cuda`` (the kernel, and each rank on the one card) unless
``--device cpu`` is given, where the kernel's plain version runs; asking
for ``cuda`` where there is none raises.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --ranks 2
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.streamed_moe import streamed_moe_kernel
from repro_torch.parallel import localrun
from repro_torch.sim import (PAPER_SPECS, PROTOTYPE_2X2, iteration_workloads,
                             simulate_layer)

# step 1: E, C, d, d_expert, micro-slices (fp32)
E1, C1, D1, DE1, M1 = 4, 16, 32, 64, 4
STEP1_TOL = 2e-5          # fp32 streamed_moe, relative to max |whole expert|
# step 2: the reference's fsedp_modes.py layer and batch
E2, K2, D2, DE2, B2, S2 = 8, 2, 32, 64, 4, 16
STEP2_TOL = 2e-4
STRATEGIES = ("fse_dp", "ep", "tp")
MODES = ("stream", "index", "slice")


def micro_slice_inputs():
    """Step 1's operands as numpy: xe (E, C, d), w_gate / w_up (E, d, de),
    w_down (E, de, d), and the order the micro-slices are taken in."""
    rng = np.random.default_rng(0)
    xe = rng.standard_normal((E1, C1, D1)).astype(np.float32)
    w = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((E1, D1, DE1), (E1, D1, DE1), (E1, DE1, D1))]
    return xe, *w, rng.permutation(M1)


def micro_slices(device):
    """-> (sum over micro-slices in a random order, the whole expert through
    ``ref.streamed_moe_ref``, the order), on ``device``."""
    xe, wg, wu, wd, order = micro_slice_inputs()
    xe, wg, wu, wd = (torch.from_numpy(a).to(device)
                      for a in (xe, wg, wu, wd))
    full = ref.streamed_moe_ref(xe, wg, wu, wd, "swiglu")
    mic = DE1 // M1
    parts = sum(streamed_moe_kernel(
        xe, wg[..., i * mic:(i + 1) * mic].contiguous(),
        wu[..., i * mic:(i + 1) * mic].contiguous(),
        wd[:, i * mic:(i + 1) * mic, :].contiguous(), activation="swiglu")
        for i in order)
    return parts, full, order


def _layer():
    """Step 2's MoE layer weights and input batch, as numpy."""
    rng = np.random.default_rng(1)
    f32 = np.float32
    params = {"w_router": (rng.standard_normal((D2, E2)) / D2 ** 0.5
                           ).astype(f32)}
    for k, shape, fan in (("w_gate", (E2, D2, DE2), D2),
                          ("w_up", (E2, D2, DE2), D2),
                          ("w_down", (E2, DE2, D2), DE2)):
        params[k] = (rng.standard_normal(shape) / fan ** 0.5).astype(f32)
    return params, rng.standard_normal((B2, S2, D2)).astype(f32)


def _moe_cfg():
    return MoEConfig(num_experts=E2, top_k=K2, d_expert=DE2,
                     capacity_factor=E2 / K2, micro_slices=2)


def _torch_params(arrays, device):
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return {"router": {"w_router": t.pop("w_router")}, **t}


def mesh_shape(ranks):
    """(data, model) for ``ranks``: a model axis of gcd(ranks, 4)."""
    P = math.gcd(ranks, 4)
    if B2 % (ranks // P):
        raise ValueError(f"--ranks {ranks}: the batch of {B2} does not split "
                         f"over {ranks // P} data groups")
    return ranks // P, P


def _rank(rank, world, job):
    """One gloo rank: its data group's rows through each strategy and each
    forced FSE-DP mode on the (data, model) mesh -> {name: y (numpy)}."""
    from repro_torch.core import autotune, strategy
    from repro_torch.parallel import meshctx
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshctx.ProcessMesh.create(job["mesh"], ("data", "model"))
    n_data, P = job["mesh"]
    rows = B2 // n_data
    dg = mesh.index("data")
    x = torch.from_numpy(job["x"][dg * rows:(dg + 1) * rows]).to(device)
    params = _torch_params(job["params"], device)
    moe = _moe_cfg()
    runs = [(name, name, None) for name in STRATEGIES]
    runs += [(f"fse_dp:{mode}", "fse_dp", autotune.plan_moe(
        rows, S2, D2, moe, "swiglu", P, dtype_bytes=4, mode=mode))
        for mode in MODES]
    out = {}
    with torch.no_grad(), meshctx.with_mesh(mesh):
        for label, name, plan in runs:
            y, _ = strategy.execute(name, params, x, moe, "swiglu", plan=plan)
            out[label] = y.cpu().numpy()
    return out


def fse_dp_vs_oracle(ranks, device):
    """-> {run: max |y - dense oracle|} over every rank's rows."""
    from repro_torch.core import gating
    from repro_torch.models import moe as moe_mod
    arrays, x = _layer()
    params = _torch_params(arrays, "cpu")
    x2d = torch.from_numpy(x).reshape(-1, D2)
    with torch.no_grad():
        routing = gating.route(params["router"], x2d, top_k=K2)
        oracle = moe_mod.moe_dense(params, x2d, routing, "swiglu").reshape(
            B2, S2, D2).numpy()
    n_data, P = mesh_shape(ranks)
    results = localrun.run(_rank, ranks, dict(
        params=arrays, x=x, mesh=(n_data, P), device=str(device)))
    rows = B2 // n_data
    errs = {}
    for r, res in enumerate(results):
        want = oracle[(r // P) * rows:(r // P + 1) * rows]
        for label, y in res.items():
            errs[label] = max(errs.get(label, 0.0),
                              float(np.abs(y - want).max()))
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== 1. micro-slice order invariance (the virtualization argument) ==")
    parts, full, order = micro_slices(device)
    err = float((parts - full).abs().max())
    rel = err / float(full.abs().max())
    print(f"   Σ(micro-slices in random order {order.tolist()}) vs whole "
          f"expert: max err = {err:.2e}  ✓ trajectory order is immaterial")
    if rel > STEP1_TOL:
        raise AssertionError(f"micro-slice sum off by {rel:.2e} of max |y| "
                             f"(tol {STEP1_TOL:g})")

    print(f"== 2. FSE-DP distributed == dense oracle ({args.ranks} gloo "
          f"ranks, mesh {mesh_shape(args.ranks)}) ==")
    errs = fse_dp_vs_oracle(args.ranks, device)
    for label, e in errs.items():
        print(f"   {label:14s} maxerr={e:.2e}")
    bad = {k: e for k, e in errs.items() if e >= STEP2_TOL}
    if bad:
        raise AssertionError(f"off the dense oracle: {bad}")
    print("   ALL MODES MATCH ORACLE")

    print("== 3. chiplet simulator: FSE-DP vs EP (paper Table-I hardware) ==")
    hw = PROTOTYPE_2X2
    spec = PAPER_SPECS["qwen3-a3b"]
    wl = iteration_workloads(spec, tokens_per_iter=64,
                             num_chiplets=hw.num_chiplets, seed=0)[0]
    sims = {}
    for strat in ("ep", "fse_dp_paired"):
        r = sims[strat] = simulate_layer(hw, spec, wl, strat)
        print(f"   {strat:14s} latency={r.latency*1e6:8.0f}us  "
              f"package-mem={r.peak_buffer_bytes/2**20:6.1f}MB  "
              f"util={r.utilization:.3f}")
    return {"parts": parts, "full": full, "step1_rel": rel, "step2": errs,
            "sim": sims}


if __name__ == "__main__":
    main()

"""Gradients through the distributed MoE bodies on the setup of the
reference's ``tests/distributed_scripts/fsedp_grad.py``: E = 8, top-2,
d = 32, d_expert = 64, capacity factor E / k (drop-free), 2 micro-slices,
x of (4, 16, d), fp32, loss ``sum(y ** 2)``; inputs and weights from a
numpy seed.

    arrays = gradcheck.inputs()
    grads = gradcheck.rank_grads(mesh, arrays, [("fse_dp", "stream",
                                                 "onehot", "static")])

Each rank of ``mesh`` holds its data group's rows and the full
parameters, takes its share of the loss (its group's loss over the model
ranks that hold it) and sums the parameter gradients over the mesh
(``collectives.psum_grads``); its rows' gradient is summed over the model
axis.  Drop-free matters: with drops, per-rank capacity drops other
tokens than one device does, and one device's gradients would not be the
oracle.
"""
from __future__ import annotations

import numpy as np
import torch

E, K, D, DE, B, S = 8, 2, 32, 64, 4, 16
LEAVES = ("router/w_router", "w_gate", "w_up", "w_down")


def case_id(case) -> str:
    """``(strategy, fse_dp mode or None, dispatch, schedule)`` -> a name."""
    return "-".join(c for c in case if c)


def moe_config():
    from repro_torch.configs.base import MoEConfig
    return MoEConfig(num_experts=E, top_k=K, d_expert=DE,
                     capacity_factor=E / K, micro_slices=2)


def inputs(seed: int = 7) -> dict:
    """x and the MoE weights, numpy fp32, keyed as :data:`LEAVES`."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"x": rng.standard_normal((B, S, D)).astype(f32),
            "router/w_router": (rng.standard_normal((D, E)) / D ** 0.5
                                ).astype(f32),
            "w_gate": (rng.standard_normal((E, D, DE)) / D ** 0.5
                       ).astype(f32),
            "w_up": (rng.standard_normal((E, D, DE)) / D ** 0.5).astype(f32),
            "w_down": (rng.standard_normal((E, DE, D)) / DE ** 0.5
                       ).astype(f32)}


def params(arrays, to):
    """The MoE parameter tree, each array through ``to``."""
    return {"router": {"w_router": to(arrays["router/w_router"])},
            **{k: to(arrays[k]) for k in ("w_gate", "w_up", "w_down")}}


def leaf(tree, key: str):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def rank_grads(mesh, arrays, cases, device="cpu") -> dict:
    """This rank's gradients for each case -> {case_id: {key: tensor}} over
    :data:`LEAVES` (summed over the mesh) and ``"x"`` (this data group's
    rows, summed over the model axis).  A case is ``(strategy, fse_dp
    mode, dispatch, schedule)``: the mode forces the plan (None: the
    strategy's own), dispatch is ``onehot`` or ``sorted``, schedule
    ``static`` or ``dynamic``."""
    from repro_torch.core import autotune, strategy, trajectory
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives, meshctx

    P = mesh.size("model")
    n_data = mesh.world_size // P
    dg = mesh.index("data") if n_data > 1 else 0
    b_grp = B // n_data
    moe = moe_config()
    out = {}
    for case in cases:
        name, mode, disp, sched = case
        p = params(arrays, lambda a: torch.from_numpy(a).to(device)
                   .requires_grad_(True))
        x = torch.from_numpy(arrays["x"][dg * b_grp:(dg + 1) * b_grp]
                             ).to(device).requires_grad_(True)
        plan = None if mode is None else autotune.plan_moe(
            b_grp, S, D, moe, "swiglu", P, dtype_bytes=4, mode=mode)
        with autotune.use_autotune("analytic"), meshctx.with_mesh(mesh), \
                moe_mod.use_sorted_dispatch(disp == "sorted"):
            y, aux = strategy.execute(
                name, p, x, moe, "swiglu", plan=plan,
                schedule=trajectory.DYNAMIC if sched == "dynamic" else None)
        loss = torch.sum(y ** 2) / P + 0.0 * aux
        grads = torch.autograd.grad(loss, [leaf(p, k) for k in LEAVES] + [x])
        got = dict(zip(LEAVES, collectives.psum_grads(grads[:-1], mesh)))
        got["x"] = collectives.psum(grads[-1], mesh, "model")
        out[case_id(case)] = got
    return out

"""Gradients through the streamed_moe dispatch layer and the MoE block:
port vs ``jax.grad`` of the reference, on the CPU.

* ``kernels.ops.streamed_moe`` (with kernels on, the port's plain version
  under its straight-through ``StreamedMoE`` backward; the reference's
  Pallas kernel in interpret mode under its custom VJP) for swiglu, gelu
  and relu2 and for the fp32 / bf16 / int8 / fp8 weight formats: every
  operand's gradient within the reference's tolerance for it, ``rtol=2e-4,
  atol=2e-5`` (``tests/test_streamed_moe_parity.py``).
* The straight-through check: int8 weights' gradients within 5% relative
  norm of the fp32 ones (the reference's
  ``test_quantized_gradients_are_straight_through`` bound).
* ``gating.route`` and ``aux_load_balance_loss``: router and input
  gradients through the softmax, the top-k weights and the aux loss.
* ``moe_capacity`` (one-hot and sorted dispatch, static and dynamic
  schedule) and ``moe_hybrid`` (a hot prefix of 2 of 4 experts): the
  gradients of x and of every weight, the router's through the combine
  weights, against the reference's oracle path (``use_kernels(False)``),
  at the same tolerance.  Capacity factor 1.25, so tokens are dropped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import gating as jgating
from repro.core import trajectory as jtraj
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating, trajectory
from repro_torch.kernels import ops
from repro_torch.models import moe

RTOL, ATOL = 2e-4, 2e-5
STE_DRIFT = 0.05
ACTS = ("swiglu", "gelu", "relu2")
FORMATS = (None, "bf16", "int8", "fp8")


def _ffn_inputs(E=2, C=8, d=32, m=48, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((E, C, d)).astype(f32),
            (rng.standard_normal((E, d, m)) / d ** 0.5).astype(f32),
            (rng.standard_normal((E, d, m)) / d ** 0.5).astype(f32),
            (rng.standard_normal((E, m, d)) / m ** 0.5).astype(f32))


def _port_ffn_grads(arrays, act, wdt):
    xe, wg, wu, wd = (torch.from_numpy(a).requires_grad_(True)
                      for a in arrays)
    wg = wg if act == "swiglu" else None
    y = ops.streamed_moe(xe, wg, wu, wd, act, weight_dtype=wdt)
    leaves = [t for t in (xe, wg, wu, wd) if t is not None]
    return y, torch.autograd.grad(torch.sum(y ** 2), leaves)


@pytest.mark.parametrize("wdt", FORMATS, ids=lambda w: w or "fp32")
@pytest.mark.parametrize("act", ACTS)
def test_streamed_moe_gradients_match_reference(act, wdt):
    arrays = _ffn_inputs()
    gated = act == "swiglu"

    def loss(xe, wg, wu, wd):
        y = jops.streamed_moe(xe, wg if gated else None, wu, wd, act,
                              weight_dtype=wdt)
        return jnp.sum(y ** 2)

    argnums = (0, 1, 2, 3) if gated else (0, 2, 3)
    with jops.use_kernels(True):
        want = jax.grad(loss, argnums=argnums)(*map(jnp.asarray, arrays))
    _, got = _port_ffn_grads(arrays, act, wdt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_quantized_gradients_are_straight_through():
    """The backward is the fp32 oracle's on the original weights: the int8
    run's gradients differ from the fp32 run's only through the cotangent
    of its (slightly different) output."""
    arrays = _ffn_inputs(seed=3)
    _, g_q = _port_ffn_grads(arrays, "swiglu", "int8")
    _, g_f = _port_ffn_grads(arrays, "swiglu", None)
    for q, f in zip(g_q, g_f):
        assert torch.isfinite(q).all()
        assert ((q - f).norm() / f.norm()).item() <= STE_DRIFT


def test_gateless_call_gives_no_gate_gradient():
    xe, wg, wu, wd = (torch.from_numpy(a).requires_grad_(True)
                      for a in _ffn_inputs())
    y = ops.streamed_moe(xe, wg, wu, wd, "relu2")
    y.sum().backward()
    assert wg.grad is None and wu.grad is not None and xe.grad is not None


def _moe_inputs(E=4, k=2, d=16, de=24, T=21, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"x": rng.standard_normal((T, d)).astype(f32),
            "router/w_router": (rng.standard_normal((d, E)) / d ** 0.5
                                ).astype(f32),
            "w_gate": (rng.standard_normal((E, d, de)) / d ** 0.5
                       ).astype(f32),
            "w_up": (rng.standard_normal((E, d, de)) / d ** 0.5).astype(f32),
            "w_down": (rng.standard_normal((E, de, d)) / de ** 0.5
                       ).astype(f32)}


def _params(arrays, to):
    return {"router": {"w_router": to(arrays["router/w_router"])},
            **{k: to(arrays[k]) for k in ("w_gate", "w_up", "w_down")}}


KEYS = ("x", "router/w_router", "w_gate", "w_up", "w_down")
MOE = dict(num_experts=4, top_k=2, d_expert=24, capacity_factor=1.25)


def test_gating_gradients_match_reference():
    """Router and input gradients through softmax, top-k renormalization,
    the combine scatter and the aux loss."""
    arrays = _moe_inputs()
    c = np.random.default_rng(1).standard_normal((21, 4)).astype(np.float32)

    def jloss(wr, x):
        r = jgating.route({"w_router": wr}, x, top_k=2)
        return (jnp.sum(r.combine * c) + jnp.sum(r.weights ** 2)
                + jgating.aux_load_balance_loss(r, 4))

    want = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(arrays["router/w_router"]), jnp.asarray(arrays["x"]))
    wr = torch.from_numpy(arrays["router/w_router"]).requires_grad_(True)
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    r = gating.route({"w_router": wr}, x, top_k=2)
    loss = (torch.sum(r.combine * torch.from_numpy(c))
            + torch.sum(r.weights ** 2)
            + gating.aux_load_balance_loss(r, 4))
    got = torch.autograd.grad(loss, (wr, x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# (block, dispatch, schedule)
BLOCKS = [("capacity", "onehot", "static"), ("capacity", "sorted", "static"),
          ("capacity", "onehot", "dynamic"), ("capacity", "sorted", "dynamic"),
          ("hybrid", "onehot", "static"), ("hybrid", "sorted", "static")]


@pytest.mark.parametrize("block,disp,sched", BLOCKS)
def test_moe_block_gradients_match_reference(block, disp, sched):
    arrays = _moe_inputs()

    def jloss(p, x):
        r = jgating.route(p["router"], x, top_k=2)
        cfg = JMoEConfig(**MOE)
        s = jtraj.Schedule(policy="dynamic") if sched == "dynamic" else None
        if block == "hybrid":
            y = jmoe.moe_hybrid(p, x, r, cfg, "swiglu", hot_experts=2)
        else:
            y = jmoe.moe_capacity(p, x, r, cfg, "swiglu", schedule=s)
        return jnp.sum(y ** 2) + jgating.aux_load_balance_loss(r, 4)

    with jops.use_kernels(False), jmoe.use_sorted_dispatch(disp == "sorted"):
        gp, gx = jax.grad(jloss, argnums=(0, 1))(_params(arrays, jnp.asarray),
                                                 jnp.asarray(arrays["x"]))
    want = {"x": gx, "router/w_router": gp["router"]["w_router"],
            **{k: gp[k] for k in ("w_gate", "w_up", "w_down")}}

    params = _params(arrays, lambda a: torch.from_numpy(a)
                     .requires_grad_(True))
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    with moe.use_sorted_dispatch(disp == "sorted"):
        r = gating.route(params["router"], x, top_k=2)
        cfg = MoEConfig(**MOE)
        s = trajectory.DYNAMIC if sched == "dynamic" else None
        if block == "hybrid":
            y = moe.moe_hybrid(params, x, r, cfg, "swiglu", hot_experts=2)
        else:
            y = moe.moe_capacity(params, x, r, cfg, "swiglu", schedule=s)
        loss = torch.sum(y ** 2) + gating.aux_load_balance_loss(r, 4)
    leaves = [x, params["router"]["w_router"]] + [
        params[k] for k in ("w_gate", "w_up", "w_down")]
    got = torch.autograd.grad(loss, leaves)
    for key, g in zip(KEYS, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)

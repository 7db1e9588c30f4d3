"""MoE FFN block (port of the single-device part of ``repro.models.moe``).

Weight layout, stacked over experts:
  w_gate, w_up : (E, d_model, d_expert)       (w_gate only for swiglu)
  w_down       : (E, d_expert, d_model)

``moe_block`` looks the strategy up in ``core.strategy``: ``dense`` (the
oracle) or ``capacity`` (one-hot dispatch into (E, C, d) rows, the
``streamed_moe`` kernel, weighted combine).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating, trajectory
from repro_torch.kernels import ops as kops
from .layers import activation_fn, dense_init
from .mlp import ffn, ffn_init


def moe_init(gen, d_model, moe: MoEConfig, activation, dtype, device, lead=()):
    E, de = moe.num_experts, moe.d_expert
    lead_e = (*lead, E)
    p = {"router": gating.router_init(gen, d_model, E, dtype, device, lead),
         "w_up": dense_init(gen, d_model, de, dtype, device, lead=lead_e),
         "w_down": dense_init(gen, de, d_model, dtype, device, lead=lead_e)}
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, de, dtype, device, lead=lead_e)
    if moe.num_shared_experts:
        p["shared"] = ffn_init(gen, d_model, de * moe.num_shared_experts,
                               activation, dtype, device, lead)
    return p


def _expert_act(params, xe, activation):
    """(E, C, d) -> (E, C, d) with per-expert einsums in the param dtype."""
    hu = torch.einsum("ecd,edf->ecf", xe, params["w_up"])
    if activation == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, params["w_gate"])) * hu
    else:
        h = activation_fn(activation)(hu)
    return torch.einsum("ecf,efd->ecd", h, params["w_down"])


def _reorder_experts(params, order):
    out = dict(params)
    for k in ("w_gate", "w_up", "w_down"):
        if k in params:
            out[k] = params[k].index_select(0, order)
    return out


def moe_dense(params, x2d, routing, activation, schedule=None):
    """x2d: (T, d) -> (T, d); every expert on every token."""
    T, d = x2d.shape
    E = params["w_up"].shape[0]
    order = trajectory.resolve_order(
        schedule, lambda: gating.expert_token_counts(routing), x2d.device)
    xe = x2d[None].expand(E, T, d)
    p = params if order is None else _reorder_experts(params, order)
    ye = _expert_act(p, xe, activation)
    if order is not None:
        ye = trajectory.restore_order(order, ye)
    return torch.einsum("te,etd->td", routing.combine, ye)


def _one_hot(idx, n):
    """``F.one_hot`` as a comparison, which checks no value on the host
    (the serving segments are captured as CUDA graphs)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def dispatch_masks(routing, T, E, C):
    """(T, E, C) dispatch one-hot and combine weights; tokens beyond an
    expert's capacity C are dropped."""
    onehot = _one_hot(routing.indices, E).sum(1)                    # (T, E)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1
    keep = (pos >= 0) & (pos < C)
    pos = torch.clamp(pos, 0, C - 1)
    dispatch = _one_hot(pos, C).float() * keep[..., None]            # (T,E,C)
    combine = dispatch * routing.combine[..., None].float()
    return dispatch, combine


def _expert_ffn(params, xe, activation):
    """(E, C, d) -> (E, C, d) fp32 through the kernel dispatch layer."""
    return kops.streamed_moe(xe, params.get("w_gate"), params["w_up"],
                             params["w_down"], activation)


def moe_capacity(params, x2d, routing, moe: MoEConfig, activation,
                 schedule=None):
    """Capacity dispatch -> grouped expert FFN -> combine.  A dynamic
    schedule reorders the expert axis for the FFN and restores it before
    the combine (values unchanged)."""
    if torch.is_grad_enabled() and x2d.requires_grad:
        raise NotImplementedError("the streamed_moe backward belongs to the "
                                  "training slice (ROADMAP A.15)")
    T, d = x2d.shape
    E = moe.num_experts
    C = moe.capacity_rows(T)
    order = trajectory.resolve_order(
        schedule, lambda: gating.expert_token_counts(routing), x2d.device)
    p = params if order is None else _reorder_experts(params, order)
    dispatch, combine = dispatch_masks(routing, T, E, C)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x2d.dtype), x2d)    # (E,C,d)
    if order is not None:
        (xe,) = trajectory.apply_order(order, xe)
    ye = _expert_ffn(p, xe.contiguous(), activation)                 # fp32
    if order is not None:
        ye = trajectory.restore_order(order, ye)
    return torch.einsum("tec,ecd->td", combine, ye).to(x2d.dtype)


def moe_block(params, x, moe: MoEConfig, activation, *, spec=None,
              phase=None, layer=None, return_aux=False, routing=None,
              schedule=None):
    """x: (B, S, d) or (T, d); a lookup into the strategy registry.
    With no ``spec``, ``moe.impl`` names the strategy."""
    from repro_torch.core import strategy as strat
    sp = strat.ExecutionSpec.coerce(spec, default=moe.impl)
    name = sp.resolve(phase=phase, layer=layer)
    if schedule is None and sp.schedule == "dynamic":
        schedule = trajectory.DYNAMIC
    shape = x.shape
    if x.dim() == 2:
        x = x[None]
    with sp.scope():
        y, aux = strat.get_strategy(name).execute(
            params, x, moe, activation, routing=routing, schedule=schedule,
            aux=return_aux)
    if moe.num_shared_experts:
        y = y + ffn(params["shared"], x, activation)
    y = y.reshape(shape)
    return (y, aux) if return_aux else y

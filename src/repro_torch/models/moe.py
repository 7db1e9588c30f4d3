"""MoE FFN block (port of the single-device part of ``repro.models.moe``).

Weight layout, stacked over experts:
  w_gate, w_up : (E, d_model, d_expert)       (w_gate only for swiglu)
  w_down       : (E, d_expert, d_model)

``moe_block`` looks the strategy up in ``core.strategy``: ``dense`` (the
oracle), ``capacity`` (dispatch into (E, C, d) rows, the
``streamed_moe`` kernel, weighted combine), ``hybrid`` (the same rows
in load order, the kernel once on a hot prefix and once on the cold
tail), or the distributed ``fse_dp``, ``ep``, ``tp`` and ``auto``
(``core.fse_dp``, ``core.baselines``; ``capacity`` on one device).
Capacity dispatch and combine move rows through the gather and combine
kernels of ``kernels.moe_dispatch`` wherever kernels are on and autograd
does not record through the call; elsewhere they are the reference's
one-hot products, or its gathers under ``use_sorted_dispatch``
(``ExecutionSpec.sorted_dispatch``).  ``ONE_HOT_CALLS`` counts the
capacity calls made with kernels on that kept the one-hot products.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating, trajectory
from repro_torch.kernels import moe_dispatch as kmd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.moe_dispatch import (gather_dispatch,  # noqa: F401
                                              scatter_combine)
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


def _tokens_ahead(onehot):
    """(T, E) 0/1 choices -> (T, E) count of earlier tokens that chose the
    same expert: a cumulative count along T, run over the rows of the
    (E, T) transpose (a scan along the outer dim of (T, E) has E-wide
    parallelism and took 0.8 ms at T = 4096 on an H100)."""
    onehot_t = onehot.t().contiguous()
    return (torch.cumsum(onehot_t, 1) - onehot_t).t()


def capacity_of(T, moe: MoEConfig):
    """Rows per expert for ``T`` routed tokens (``moe.capacity_rows``)."""
    return moe.capacity_rows(T)


def dispatch_masks(routing, T, E, C):
    """(T, E, C) dispatch one-hot and combine weights; tokens beyond an
    expert's capacity C are dropped."""
    onehot = _one_hot(routing.indices, E).sum(1)                    # (T, E)
    pos = (_tokens_ahead(onehot) + 1) * onehot - 1
    keep = (pos >= 0) & (pos < C)
    pos = torch.clamp(pos, 0, C - 1)
    dispatch = _one_hot(pos, C).float() * keep[..., None]            # (T,E,C)
    combine = dispatch * routing.combine[..., None].float()
    return dispatch, combine


def _expert_ffn(params, xe, activation):
    """(E, C, d) -> (E, C, d) fp32 through the kernel dispatch layer, with
    the planner's tiles (``kernels.ops.streamed_moe_autotuned``)."""
    return kops.streamed_moe_autotuned(xe, params.get("w_gate"),
                                       params["w_up"], params["w_down"],
                                       activation)


ONE_HOT_CALLS = 0


def _rows_by_kernel(params, x2d, routing) -> bool:
    """Whether a capacity call moves its rows through the kernels of
    ``kernels.moe_dispatch`` (their plain versions on CPU tensors): with
    kernels on, unless autograd records through the call.  The kernels
    have no backward, so training keeps the one-hot products, whose VJP
    is the reference's."""
    if not kops.kernels_enabled():
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(t is not None and t.requires_grad for t in (
        x2d, routing.weights, params.get("w_gate"), params["w_up"],
        params["w_down"]))


def _capacity_rows(params, x2d, routing, E, C, order, ffn):
    """Dispatch into (E, C, d) rows in ``order`` (None: canonical) ->
    ``ffn`` -> canonical order -> combine, in x2d's dtype.  Both
    dispatches return the model dtype: the reference's sorted path
    returns fp32, which would promote a bf16 residual stream, and the
    fused segments' buffers keep one dtype."""
    global ONE_HOT_CALLS
    T = x2d.shape[0]
    kernel = _rows_by_kernel(params, x2d, routing)
    if kernel or sorted_dispatch_enabled():
        tables = dispatch_tables(routing, T, E, C)
        idx = tables.idx if order is None else tables.idx.index_select(0,
                                                                       order)
        gather = kmd.gather_dispatch_kernel if kernel else gather_dispatch
        ye = ffn(gather(x2d, idx))
        if order is not None:
            ye = trajectory.restore_order(order, ye)
        if kernel:
            return kmd.scatter_combine_kernel(ye, tables.rows, tables.weights,
                                              x2d.dtype)
        return scatter_combine(ye, tables.rows, tables.weights).to(x2d.dtype)
    if kops.kernels_enabled():
        ONE_HOT_CALLS += 1
    dispatch, combine = dispatch_masks(routing, T, E, C)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x2d.dtype), x2d)    # (E,C,d)
    if order is not None:
        (xe,) = trajectory.apply_order(order, xe)
    ye = ffn(xe.contiguous())                                         # fp32
    if order is not None:
        ye = trajectory.restore_order(order, ye)
    return one_hot_combine(combine, ye).to(x2d.dtype)


def moe_capacity(params, x2d, routing, moe: MoEConfig, activation,
                 schedule=None):
    """Capacity dispatch -> grouped expert FFN -> combine.  A dynamic
    schedule reorders the expert axis for the FFN and restores it before
    the combine (values unchanged)."""
    T = x2d.shape[0]
    order = trajectory.resolve_order(
        schedule, lambda: gating.expert_token_counts(routing), x2d.device)
    p = params if order is None else _reorder_experts(params, order)
    return _capacity_rows(params, x2d, routing, moe.num_experts,
                          moe.capacity_rows(T), order,
                          lambda xe: _expert_ffn(p, xe, activation))


def one_hot_combine(combine, ye):
    """(T, E, C) combine weights x (E, C, d) fp32 expert rows -> (T, d) fp32.

    One product per expert, (E, T, C) @ (E, C, d), in which each (expert,
    token) pair has at most one non-zero term, so every partial is exact
    whatever split the GEMM takes; then one sum over E of fixed shape.  A
    token's sum so never depends on its capacity rows, which move with
    whoever shares the batch.  (A single (T, E·C) product grouped a
    token's k terms by where they fell along E·C: on an H100 a token's
    output then moved with the slot and the batch.)"""
    return torch.bmm(combine.transpose(0, 1), ye).sum(0)


# ---------------------------------------------------------------------------
# hybrid two-tier dispatch: a hot prefix on the fast array, a cold tail near
# memory.  The expert axis is a batch axis of the grouped FFN, so running
# it as two groups gives the one group's bits.
# ---------------------------------------------------------------------------


def _expert_ffn_tiered(params, xe, activation, hot):
    """(E, C, d) -> (E, C, d) fp32 as a hot prefix ``[:hot]`` and a cold
    tail ``[hot:]`` of the (trajectory-ordered) expert axis, each through
    ``_expert_ffn``; ``hot`` of 0 or E is one call."""
    E = xe.shape[0]
    H = max(0, min(int(hot), E))
    if H in (0, E):
        return _expert_ffn(params, xe, activation)

    def _slice(a, b):
        return {k: (v[a:b] if k in ("w_gate", "w_up", "w_down") else v)
                for k, v in params.items()}

    y_hot = _expert_ffn(_slice(0, H), xe[:H], activation)
    y_cold = _expert_ffn(_slice(H, E), xe[H:], activation)
    return torch.cat([y_hot, y_cold], 0)


def moe_hybrid(params, x2d, routing, moe: MoEConfig, activation, *,
               hot_experts, schedule=None):
    """Capacity dispatch -> two-tier grouped FFN -> combine, bit for bit
    ``moe_capacity`` on the same routing.

    Experts go in load-descending order: the schedule's host load (the
    engine's EMA) when it carries one, else this call's own counts
    through a stable sort on the device, so the fused segments need no
    new host input.  The ``hot_experts`` hottest form the fast-tier
    prefix, and canonical order is restored before the combine."""
    T, d = x2d.shape
    E = moe.num_experts
    C = moe.capacity_rows(T)
    if schedule is not None and schedule.load is not None:
        order = torch.as_tensor(
            np.argsort(-np.asarray(schedule.load), kind="stable"),
            dtype=torch.int64, device=x2d.device)
    else:
        counts = gating.expert_token_counts(routing)
        order = torch.sort(-counts.to(torch.int64), stable=True).indices
    p = _reorder_experts(params, order)
    return _capacity_rows(
        params, x2d, routing, E, C, order,
        lambda xe: _expert_ffn_tiered(p, xe, activation, hot_experts))


# ---------------------------------------------------------------------------
# sorted dispatch: gathers in place of the one-hot products, which cost
# O(T·E·C·d) operations to move T·k rows.  Where the kernels do not move
# the rows (kernels off, or autograd recording), one-hot stays the
# default, as in the reference; the kernels read the same tables.
# ---------------------------------------------------------------------------

_SORTED = contextvars.ContextVar("repro_torch_sorted_dispatch", default=False)


@contextlib.contextmanager
def use_sorted_dispatch(enabled: bool = True):
    tok = _SORTED.set(enabled)
    try:
        yield
    finally:
        _SORTED.reset(tok)


def sorted_dispatch_enabled() -> bool:
    """``use_sorted_dispatch``, or the mesh context's ``'sorted'`` option
    (``meshctx.with_opts``), as the reference reads it."""
    from repro_torch.parallel import meshctx
    return _SORTED.get() or meshctx.opt_enabled("sorted")


class DispatchTables(NamedTuple):
    idx: torch.Tensor        # (E, C) token ids, T for an empty row
    rows: torch.Tensor       # (T, k) each choice's row of the flat (E*C),
    #                          E*C where it overflowed
    weights: torch.Tensor    # (T, k) its weight, 0 where it overflowed


def dispatch_tables(routing, T, E, C) -> DispatchTables:
    """The reference's idx table, plus each token's k choices in
    ascending expert order (``rows``, ``weights``) for the combine.

    An expert's rows hold its tokens in token order, so a choice's row is
    the count of earlier tokens routed to the same expert: what the
    reference's stable sort by expert gives, found here by a cumulative
    count (only each token's k choices are sorted), with nothing read
    back by the host (the serving segments are captured as CUDA graphs).
    Choices past C overflow.  The reference drops them out of range;
    here they are written to a sink column C of an (E, C + 1) table that
    is then cut off, and their row is E*C, one past the last, which the
    combine reads as 0."""
    k = routing.indices.shape[1]
    dev = routing.indices.device
    experts, perm = torch.sort(routing.indices, dim=1)
    w = routing.weights.gather(1, perm)
    onehot = _one_hot(routing.indices, E).sum(1)                    # (T, E)
    pos = _tokens_ahead(onehot).gather(1, experts)                   # (T, k)
    keep = pos < C
    dest = (experts * (C + 1) + pos.clamp(max=C)).reshape(-1)
    tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    idx = torch.full((E * (C + 1),), T, dtype=torch.int64, device=dev)
    idx.scatter_(0, dest, tok)
    return DispatchTables(idx.view(E, C + 1)[:, :C],
                          torch.where(keep, experts * C + pos, E * C),
                          torch.where(keep, w, torch.zeros_like(w)))


def moe_block(params, x, moe: MoEConfig, activation, *, impl=None,
              spec=None, phase=None, layer=None, mesh_axis="model",
              return_aux=False, routing=None, schedule=None):
    """x: (B, S, d) or (T, d); a lookup into the strategy registry.
    ``impl`` is the reference's legacy name for ``spec``; with neither,
    ``moe.impl`` names the strategy.  The distributed
    strategies (fse_dp / ep / tp / auto) run over the active mesh's
    ``mesh_axis`` (``parallel.meshctx``), on this model group's rows, and
    as ``capacity`` without one."""
    from repro_torch.core import strategy as strat
    sp = strat.ExecutionSpec.coerce(spec if spec is not None else impl,
                                    default=moe.impl)
    name = sp.resolve(phase=phase, layer=layer)
    if schedule is None and sp.schedule == "dynamic":
        schedule = trajectory.DYNAMIC
    shape = x.shape
    if x.dim() == 2:
        x = x[None]
    with sp.scope():
        y, aux = strat.get_strategy(name).execute(
            params, x, moe, activation, axis=mesh_axis, routing=routing,
            schedule=schedule, aux=return_aux)
    if moe.num_shared_experts:
        y = y + ffn(params["shared"], x, activation)
    y = y.reshape(shape)
    return (y, aux) if return_aux else y

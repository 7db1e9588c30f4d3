"""The distributed baselines the paper measures FSE-DP against (port of
``repro.core.baselines``).

EP, expert parallelism: each rank of the ``model`` axis owns E/P whole
experts; dispatched rows go to their owner by an all-to-all and come back
by another.  Capacity-bounded buffers drop tokens under skewed routing.

TP, tensor parallelism: every expert's ``d_expert`` is sliced over the
model axis, tokens are replicated, partial outputs are psum'd.

Both run their expert GEMMs through ``fse_dp._expert_partial`` with no
tile setting, so the tile planner picks per call as it does for the
FSE-DP modes.  The layout is ``core.fse_dp``'s: each rank holds its data
group's rows and returns y as it received x.  Under the mesh steps'
sharding layout the expert stacks are the rank's stored d_expert slices:
TP takes them as they are, EP gathers them over the model axis first
and takes its owned experts (``shard_map``'s reshard; the same values).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.parallel import collectives, meshctx, sharding
from . import gating, trajectory
from .fse_dp import (_aux, _expert_partial, _route, moe_fse_dp,  # noqa: F401
                     pmean_all, shard_expert_weights)


# ---------------------------------------------------------------------------
# EP: all-to-all dispatch to the experts' owners
# ---------------------------------------------------------------------------


def _local_ep(x, wr, w_g, w_u, w_d, *, moe, activation, mesh, axis,
              schedule=None, aux=True):
    """x: (B_loc, S_loc, d), this rank's tokens; w_*: (E_loc, ...), its
    owned experts.  A dynamic schedule orders the owned experts by the
    counts summed over the model axis (a host-built order indexes global
    experts, so it is derived here in any case); it permutes the owned
    experts around the FFN only, so the bits are the static ones."""
    from repro_torch.models.moe import dispatch_masks, one_hot_combine
    B, S, d = x.shape
    E = moe.num_experts
    P_ = mesh.size(axis)
    E_loc = E // P_
    x2d = x.reshape(B * S, d)
    T_loc = x2d.shape[0]
    C = moe.capacity_rows(T_loc)

    routing = _route(wr, x2d, moe)
    order = None
    if schedule is not None and schedule.dynamic:
        counts = collectives.psum(gating.expert_token_counts(routing), mesh,
                                  axis)
        r = mesh.index(axis)
        order = trajectory.traced_order(counts[r * E_loc:(r + 1) * E_loc])
    dispatch, combine = dispatch_masks(routing, T_loc, E, C)         # (T,E,C)
    xsend = torch.einsum("tec,td->ecd", dispatch.to(x2d.dtype), x2d)
    # rows -> the experts' owners; what arrives is stacked by source rank
    xrecv = collectives.all_to_all(xsend.contiguous(), mesh, axis)
    xrecv = xrecv.reshape(P_, E_loc, C, d).transpose(0, 1) \
        .reshape(E_loc, P_ * C, d)
    if order is None:
        ye = _expert_partial(xrecv, w_g, w_u, w_d, activation)
    else:
        xrecv, w_g, w_u, w_d = trajectory.apply_order(order, xrecv, w_g,
                                                      w_u, w_d)
        ye = trajectory.restore_order(
            order, _expert_partial(xrecv, w_g, w_u, w_d, activation))
    ye = ye.to(x.dtype)
    ysend = ye.reshape(E_loc, P_, C, d).transpose(0, 1) \
        .reshape(P_ * E_loc, C, d)
    yrecv = collectives.all_to_all(ysend.contiguous(), mesh, axis)
    y = one_hot_combine(combine, yrecv.float())
    return y.reshape(B, S, d).to(x.dtype), _aux(routing, moe, mesh, aux)


def moe_ep(params, x, moe: MoEConfig, activation, *, axis="model",
           schedule=None, routing=None, aux=True):
    """EP over the model axis; FSE-DP (so ``capacity`` on one device) where
    it cannot lower: one rank, E % P != 0, or tokens that neither the
    sequence nor the batch shards over P."""
    P_ = meshctx.model_axis_size(axis)
    if P_ == 1 or moe.num_experts % P_:
        return moe_fse_dp(params, x, moe, activation, axis=axis,
                          schedule=schedule, routing=routing, aux=aux)
    if routing is not None:
        raise ValueError("precomputed Routing is only supported on the "
                         "single-device path")
    mesh = meshctx.get_mesh()
    B, S, _ = x.shape
    r = mesh.index(axis)
    # tokens: the sequence sharded over the model axis when it divides
    # (train / prefill), else the batch (decode with S < P), else no EP
    if S % P_ == 0:
        dim, n = 1, S // P_
        x_loc = x[:, r * n:(r + 1) * n]
    elif B % P_ == 0:
        dim, n = 0, B // P_
        x_loc = x[r * n:(r + 1) * n]
    else:
        return moe_fse_dp(params, x, moe, activation, axis=axis,
                          schedule=schedule, aux=aux)
    E_loc = moe.num_experts // P_
    owned = slice(r * E_loc, (r + 1) * E_loc)
    params = sharding.gather_experts(params, axis)
    w_g = params.get("w_gate")
    y, a = _local_ep(x_loc, params["router"]["w_router"],
                     None if w_g is None else w_g[owned],
                     params["w_up"][owned], params["w_down"][owned], moe=moe,
                     activation=activation, mesh=mesh, axis=axis,
                     schedule=schedule, aux=aux)
    return collectives.all_gather(y, mesh, axis, dim=dim), a


# ---------------------------------------------------------------------------
# TP: d_expert sliced, tokens replicated, psum combine
# ---------------------------------------------------------------------------


def _local_tp(x, wr, w_g, w_u, w_d, *, moe, activation, mesh, axis,
              schedule=None, aux=True):
    """Route the replicated tokens, dispatch, the FFN on this rank's
    d_expert slice of all E experts, psum combine."""
    from repro_torch.models.moe import dispatch_masks, one_hot_combine
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    T = x2d.shape[0]
    C = moe.capacity_rows(T)
    routing = _route(wr, x2d, moe)
    order = trajectory.resolve_order(
        schedule, lambda: gating.expert_token_counts(routing), x.device)
    dispatch, combine = dispatch_masks(routing, T, moe.num_experts, C)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x2d.dtype), x2d)
    if order is None:
        ye = _expert_partial(xe, w_g, w_u, w_d, activation)
    else:
        xe, w_g, w_u, w_d = trajectory.apply_order(order, xe, w_g, w_u, w_d)
        ye = trajectory.restore_order(
            order, _expert_partial(xe, w_g, w_u, w_d, activation))
    y = collectives.psum(one_hot_combine(combine, ye), mesh, axis)
    return y.reshape(B, S, d).to(x.dtype), _aux(routing, moe, mesh, aux)


def moe_tp(params, x, moe: MoEConfig, activation, *, axis="model",
           schedule=None, routing=None, aux=True):
    """TP over the model axis; ``capacity`` on one device."""
    P_ = meshctx.model_axis_size(axis)
    if P_ == 1:
        return moe_fse_dp(params, x, moe, activation, axis=axis,
                          schedule=schedule, routing=routing, aux=aux)
    if routing is not None:
        raise ValueError("precomputed Routing is only supported on the "
                         "single-device path")
    mesh = meshctx.get_mesh()
    w_g, w_u, w_d = shard_expert_weights(params, mesh.index(axis), P_, axis)
    return _local_tp(x, params["router"]["w_router"], w_g, w_u, w_d, moe=moe,
                     activation=activation, mesh=mesh, axis=axis,
                     schedule=schedule, aux=aux)


def _ep_entry(params, x, moe, activation, *, axis="model"):
    """Deprecated: ``strategy.execute("ep", ...)`` or
    ``moe_block(spec=...)``; warns once per process."""
    from .strategy import warn_deprecated_entry
    warn_deprecated_entry("ep_moe_3d", "ep")
    return moe_ep(params, x, moe, activation, axis=axis)


def _tp_entry(params, x, moe, activation, *, axis="model"):
    """Deprecated: ``strategy.execute("tp", ...)`` or
    ``moe_block(spec=...)``; warns once per process."""
    from .strategy import warn_deprecated_entry
    warn_deprecated_entry("tp_moe_3d", "tp")
    return moe_tp(params, x, moe, activation, axis=axis)


# the reference's legacy entry points, bound by assignment
ep_moe_3d = _ep_entry
tp_moe_3d = _tp_entry

"""FSE-DP, Fully Sharded Expert Data-parallelism: the paper's expert
streaming (port of ``repro.core.fse_dp``).

Every rank on the ``model`` axis of a :class:`~repro_torch.parallel.
meshctx.ProcessMesh` takes 1/P of every expert's FFN weights, sliced
along ``d_expert``; the slices stream around the ring of the model axis
(``collectives.ring_shift``, the reference's ``ppermute``), each cut into
``micro_slices`` so the ring runs P·M finer steps.  A step posts the
shift of the micro-slice it holds first, then runs the grouped FFN on it
through the ``streamed_moe`` kernel, then takes the arriving one (Rule 1
of the paper: the transfer overlaps the compute).  The partial outputs
over the slices add up in fp32 in arrival order, the reference's order.

Three modes, from the token layout (paper Fig. 3):

  stream: tokens sequence-sharded, weight slices circulate (train/prefill)
  index:  tokens replicated; each rank takes a 1/P token slice and the
          outputs are all-gathered (decode with enough tokens)
  slice:  tiny-token fallback: weights stay put, every rank computes its
          d_expert slice for all tokens, partial outputs psum'd

**Layout.** ``shard_map`` takes global arrays and slices them; here each
rank of a model group holds its data group's rows of x (all of B when
the data axes do not divide it) and returns y in the layout it received:
``stream`` ends with an all-gather of the sequence shards over the model
group, the reshard XLA inserts when the next layer reads x whole.  The
expert weights are the full stacks, which a rank slices, or, under the
mesh steps' sharding layout (``parallel.sharding.with_layout``), the
rank's stored d_expert slices, taken as they are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives, meshctx
from . import gating, trajectory
# the deprecated mode heuristic, exported here as in the reference
from .autotune import pick_mode  # noqa: F401


def pmean_all(x, mesh):
    """Mean over every rank of the mesh (the world the mesh lays out)."""
    return collectives.psum(x, mesh) / mesh.world_size


# ---------------------------------------------------------------------------
# local grouped GEMM over one micro-slice
# ---------------------------------------------------------------------------


def _expert_partial(xe, w_g, w_u, w_d, activation, kopts=None):
    """xe: (E, C, d); w_g / w_u: (E, d, m); w_d: (E, m, d) -> (E, C, d)
    fp32 through ``kernels.ops``: the plan's tile setting (``kopts``,
    ``Plan.kernel_opts()``), or the tile planner per call when none."""
    xe, w_u, w_d = xe.contiguous(), w_u.contiguous(), w_d.contiguous()
    w_g = None if w_g is None else w_g.contiguous()
    if not kopts:
        return kops.streamed_moe_autotuned(xe, w_g, w_u, w_d, activation)
    return kops.streamed_moe(xe, w_g, w_u, w_d, activation, **dict(kopts))


def _ring_stream(xe, w_g, w_u, w_d, activation, mesh, axis, micro_slices,
                 kopts=None, order=None):
    """Full expert outputs for the local dispatched rows ``xe`` while the
    weight micro-slices stream around the ``axis`` ring.

    w_*: the local shard (E, d, de_loc) / (E, de_loc, d).  At step s a
    rank holds the slice of rank (r - s) mod P.  ``order`` (a dynamic
    schedule's trajectory) reindexes the rows and every arriving slice
    locally and is undone on the sum; the circulated slices stay in
    canonical order.  The last hop is not sent: the reference discards
    what it carries."""
    P_ = mesh.size(axis)
    de_loc = w_u.shape[-1]
    M = max(1, min(micro_slices, de_loc))
    while de_loc % M:
        M -= 1             # the largest feasible count <= the requested one
    mic = de_loc // M

    if order is not None:
        (xe,) = trajectory.apply_order(order, xe)
    acc = torch.zeros(xe.shape, dtype=torch.float32, device=xe.device)
    gated = w_g is not None
    for m in range(M):
        sl = slice(m * mic, (m + 1) * mic)
        cur = [w_u[..., sl].contiguous(), w_d[:, sl, :].contiguous()]
        if gated:
            cur.insert(0, w_g[..., sl].contiguous())
        for s in range(P_):
            # Rule 1: post the shift of the slice in hand, then compute
            shift = collectives.ring_shift(cur, mesh, axis) \
                if s < P_ - 1 else None
            kw = cur if order is None else trajectory.apply_order(order, *cur)
            kg, (ku, kd) = (kw[0], kw[1:]) if gated else (None, kw)
            acc = acc + _expert_partial(xe, kg, ku, kd, activation, kopts)
            if shift is not None:
                cur = shift.wait()
    if order is not None:
        acc = trajectory.restore_order(order, acc)
    return acc


# ---------------------------------------------------------------------------
# the bodies: route -> schedule -> dispatch -> combine over each dataflow
# ---------------------------------------------------------------------------


def _route(wr, x2d, moe):
    return gating.route({"w_router": wr}, x2d, top_k=moe.top_k)


def _schedule_order(schedule, routing, device):
    """The trajectory, or None for a static schedule; a dynamic one without
    a host order derives it from this rank's own routing counts."""
    return trajectory.resolve_order(
        schedule, lambda: gating.expert_token_counts(routing), device)


def _dispatch(x2d, routing, moe, order=None):
    """-> (xe, combiner): combiner(ye fp32 (E, C, d)) -> y (T, d) fp32.
    ``order`` reindexes the rows into trajectory order; the combiner
    takes canonical order."""
    from repro_torch.models.moe import (dispatch_masks, dispatch_tables,
                                        gather_dispatch, one_hot_combine,
                                        scatter_combine,
                                        sorted_dispatch_enabled)
    T = x2d.shape[0]
    C = moe.capacity_rows(T)
    if sorted_dispatch_enabled():
        tables = dispatch_tables(routing, T, moe.num_experts, C)
        xe = gather_dispatch(x2d, tables.idx)
        if order is not None:
            (xe,) = trajectory.apply_order(order, xe)
        return xe, lambda ye: scatter_combine(ye, tables.rows,
                                              tables.weights)
    dispatch, combine = dispatch_masks(routing, T, moe.num_experts, C)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x2d.dtype), x2d)
    if order is not None:
        (xe,) = trajectory.apply_order(order, xe)
    return xe, lambda ye: one_hot_combine(combine, ye)


def _aux(routing, moe, mesh, aux):
    if not aux:
        return None
    return pmean_all(gating.aux_load_balance_loss(routing, moe.num_experts),
                     mesh)


def _local_moe_stream(x, wr, w_g, w_u, w_d, *, moe, activation, mesh, axis,
                      micro_slices=None, kopts=None, schedule=None,
                      aux=True):
    """x: (B, S_loc, d), this rank's sequence shard: tokens stationary,
    weights stream."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    routing = _route(wr, x2d, moe)
    order = _schedule_order(schedule, routing, x.device)
    xe, combine = _dispatch(x2d, routing, moe)
    ye = _ring_stream(xe, w_g, w_u, w_d, activation, mesh, axis,
                      micro_slices or moe.micro_slices, kopts, order)
    y = combine(ye)
    return y.reshape(B, S, d).to(x.dtype), _aux(routing, moe, mesh, aux)


def _local_moe_index(x, wr, w_g, w_u, w_d, *, moe, activation, mesh, axis,
                     micro_slices=None, kopts=None, schedule=None,
                     aux=True):
    """x replicated over ``axis``: each rank takes a 1/P token slice,
    streams the weights, then all-gathers the outputs (the reference's
    scatter into zeros + psum, which is the same values)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    T = x2d.shape[0]
    P_ = mesh.size(axis)
    if T % P_:
        raise ValueError(f"index mode needs T % P == 0 (T={T}, P={P_})")
    T_loc = T // P_
    r = mesh.index(axis)
    x_loc = x2d[r * T_loc:(r + 1) * T_loc]
    routing = _route(wr, x_loc, moe)
    order = _schedule_order(schedule, routing, x.device)
    xe, combine = _dispatch(x_loc, routing, moe)
    ye = _ring_stream(xe, w_g, w_u, w_d, activation, mesh, axis,
                      micro_slices or moe.micro_slices, kopts, order)
    y = collectives.all_gather(combine(ye), mesh, axis)
    return y.to(x.dtype).reshape(B, S, d), _aux(routing, moe, mesh, aux)


def _local_moe_slice(x, wr, w_g, w_u, w_d, *, moe, activation, mesh, axis,
                     micro_slices=None, kopts=None, schedule=None,
                     aux=True):
    """Tiny-token fallback: weights stationary, every rank computes its
    d_expert slice for all tokens, psum combine."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    routing = _route(wr, x2d, moe)
    order = _schedule_order(schedule, routing, x.device)
    xe, combine = _dispatch(x2d, routing, moe, order)
    if order is not None:
        w_g, w_u, w_d = trajectory.apply_order(order, w_g, w_u, w_d)
    ye = _expert_partial(xe, w_g, w_u, w_d, activation, kopts)
    if order is not None:
        ye = trajectory.restore_order(order, ye)
    y = collectives.psum(combine(ye), mesh, axis)
    return y.reshape(B, S, d).to(x.dtype), _aux(routing, moe, mesh, aux)


BODIES = {"stream": _local_moe_stream, "index": _local_moe_index,
          "slice": _local_moe_slice}


def shard_expert_weights(params, r, P_, axis="model"):
    """(w_gate or None, w_up, w_down) of rank ``r``'s 1/P d_expert slice:
    the stacks as given where the sharding layout stores them split on
    ``axis`` (they are that slice), else sliced from the full stacks."""
    from repro_torch.parallel import sharding
    lay = sharding.get_layout()
    if lay is not None and lay.experts_on(axis):
        return params.get("w_gate"), params["w_up"], params["w_down"]
    de = params["w_up"].shape[-1]
    if de % P_:
        raise ValueError(f"d_expert {de} does not split over {P_} ranks")
    sl = slice(r * (de // P_), (r + 1) * (de // P_))
    w_g = params.get("w_gate")
    return (None if w_g is None else w_g[..., sl], params["w_up"][..., sl],
            params["w_down"][:, sl, :])


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def moe_fse_dp(params, x, moe: MoEConfig, activation, *, axis="model",
               plan=None, schedule=None, routing=None, aux=True):
    """x: (B, S, d), this model group's rows.  Returns (y, aux; aux None
    when ``aux`` is False).  With no model axis of size > 1 it is the
    single-device ``capacity`` path.

    The mode, micro-slice count and tile setting come from a
    ``core.autotune.Plan``: the one passed, the schedule's, or
    ``plan_moe`` on this group's batch at the ambient autotune level.
    ``schedule`` picks the expert trajectory (dynamic: the same bits,
    another order); ``routing`` is taken only on one device (the bodies
    route their own token rows)."""
    if schedule is not None and schedule.plan is not None and plan is None:
        plan = schedule.plan
    P_ = meshctx.model_axis_size(axis)
    if P_ == 1:
        from repro_torch.models.moe import moe_capacity
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        if routing is None:
            routing = gating.route(params["router"], x2d, top_k=moe.top_k)
        y = moe_capacity(params, x2d, routing, moe, activation,
                         schedule=schedule)
        return y.reshape(shape), (gating.aux_load_balance_loss(
            routing, moe.num_experts) if aux else None)
    if routing is not None:
        raise ValueError("precomputed Routing is only supported on the "
                         "single-device path; distributed bodies route "
                         "their local token rows")
    mesh = meshctx.get_mesh()
    B, S, d = x.shape
    if plan is None:
        from repro_torch.core import autotune
        from repro_torch.kernels import quant
        plan = autotune.plan_moe(B, S, d, moe, activation, P_,
                                 dtype_bytes=x.element_size(),
                                 weight_bytes=quant.weight_bytes())
    r = mesh.index(axis)
    w_g, w_u, w_d = shard_expert_weights(params, r, P_, axis)
    x_loc = x
    if plan.mode == "stream":
        if S % P_:
            raise ValueError(f"stream mode needs S % P == 0 (S={S}, P={P_})")
        x_loc = x[:, r * (S // P_):(r + 1) * (S // P_)]
    y, a = BODIES[plan.mode](
        x_loc, params["router"]["w_router"], w_g, w_u, w_d, moe=moe,
        activation=activation, mesh=mesh, axis=axis,
        micro_slices=plan.micro_slices, kopts=plan.kernel_opts(),
        schedule=schedule, aux=aux)
    if plan.mode == "stream":
        y = collectives.all_gather(y, mesh, axis, dim=1)
    return y, a


def _fse_dp_entry(params, x, moe, activation, *, axis="model", plan=None):
    """Deprecated: ``strategy.execute("fse_dp", ...)`` or
    ``moe_block(spec=...)``; warns once per process."""
    from .strategy import warn_deprecated_entry
    warn_deprecated_entry("fse_dp_moe_3d", "fse_dp")
    return moe_fse_dp(params, x, moe, activation, axis=axis, plan=plan)


# the reference's legacy entry point, bound by assignment
fse_dp_moe_3d = _fse_dp_entry

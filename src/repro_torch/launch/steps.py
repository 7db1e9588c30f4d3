"""Step functions (train / prefill / serve) on a mesh of ranks, with the
production shardings (port of ``repro.launch.steps``).

``build_*`` returns ``(fn, in_shardings, out_shardings, structs)``, as the
reference's do: ``structs`` are the global inputs as ``meta`` tensors
(``launch.specs``), the shardings trees of ``parallel.sharding.
NamedSharding`` over them, and ``fn`` takes and returns this rank's
blocks.  :func:`shard_tree` cuts a global tree into this rank's blocks,
:func:`gather_tree` puts one back together.

Where GSPMD partitions the reference's program, a port step runs the
layout by hand (``parallel.sharding``): each rank stores its block of
every parameter and AdamW moment; the model gathers each leaf as it uses
it (per period with ``unshard``), keeping the MoE experts' d_expert
slices on ``model`` for the FSE-DP ring; a data group's ranks compute
its rows.  The train step's gradients come back through the gathers'
reduce-scatters, are summed over the axes a leaf is replicated on, and
clip by the norm of the whole gradient; AdamW updates each block in
place.  Its loss is the global mean, the same on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import collectives, meshctx
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import FSDP_THRESHOLD, gather_tree, shard_tree
from . import specs as S
from .mesh import data_axes

__all__ = ["build_prefill_step", "build_serve_step", "build_step",
           "build_train_step", "gather_tree", "needs_fsdp",
           "needs_fsdp_infer", "shard_tree", "state_dtype"]


def _moe_spec(cfg: ModelConfig, distributed: bool):
    """The step's MoE ExecutionSpec: the arch's configured strategy on the
    mesh, the single-device capacity path otherwise (see
    ``repro_torch.core.strategy``)."""
    if cfg.moe is None:
        return None
    from repro_torch.core.strategy import ExecutionSpec
    return ExecutionSpec(strategy=cfg.moe.impl if distributed else "capacity")


def needs_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > FSDP_THRESHOLD


def needs_fsdp_infer(cfg: ModelConfig) -> bool:
    """Inference shards params over 'model' only unless bf16 params
    exceed ~12 GB a rank on the 16-wide model axis (nemotron-4-340b)."""
    return cfg.param_count() * 2 / 16 > 12e9


def state_dtype(cfg: ModelConfig) -> torch.dtype:
    """bf16 optimizer state above the FSDP threshold."""
    return torch.bfloat16 if needs_fsdp(cfg) else torch.float32


def _indices(batch):
    """Token ids as int64 (the structs hold the reference's int32)."""
    return {k: v.long() if k in ("tokens", "labels") else v
            for k, v in batch.items()}


def _split_axes(sharding) -> tuple:
    """The mesh axes dim 0 of a batch leaf is split over."""
    return shd._axes(tuple(sharding.spec)[0]) if len(sharding.spec) else ()


def _psum_axes(t, mesh, axes):
    for a in axes:
        if mesh.size(a) > 1:
            t = collectives.psum(t, mesh, a)
    return t


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     lr: float = 1e-4, distributed: bool = True,
                     remat: Optional[bool] = None):
    """The sharded train step: ``fn(params, opt_state, batch) -> (params,
    opt_state, loss)``; ZeRO-3 (fsdp) as ``needs_fsdp(cfg)`` says."""
    return train_step_for(cfg, shape, mesh, fsdp=needs_fsdp(cfg), lr=lr,
                          distributed=distributed, remat=remat)


def train_step_for(cfg: ModelConfig, shape: ShapeSpec, mesh, *, fsdp: bool,
                   lr: float = 1e-4, distributed: bool = True,
                   remat: Optional[bool] = None,
                   unshard: Optional[bool] = None):
    """:func:`build_train_step` with the layout's ``fsdp`` given (as
    ``param_shardings`` takes it) and ``unshard`` (default: ``fsdp``, as
    the reference's step passes it)."""
    remat = True if remat is None else remat
    unshard = fsdp if unshard is None else unshard
    spec = _moe_spec(cfg, distributed)
    baxes = data_axes(mesh)

    pstruct = S.params_struct(cfg)
    ostruct = adamw.init(pstruct, state_dtype=state_dtype(cfg))
    bstruct = S.batch_struct(cfg, shape)
    psh = shd.param_shardings(pstruct, mesh, fsdp=fsdp)
    osh = shd.opt_shardings(ostruct, pstruct, mesh, fsdp=fsdp)
    bsh = shd.batch_shardings(bstruct, mesh, baxes)
    rep = shd.replicated(mesh)
    layout = shd.Layout.of(psh, mesh)
    leaf_sh = tree.leaves(psh)
    split = _split_axes(bsh["labels"])
    copies = mesh.world_size // math.prod(mesh.size(a) for a in split)

    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _indices(batch)
        with meshctx.with_mesh(mesh), shd.with_layout(layout):
            loss, _ = api.loss_fn(params, batch, cfg, spec=spec, remat=remat,
                                  unshard=unshard)
            # this rank's share: its rows' loss weighted by their share of
            # the scored tokens, over the ranks that compute the same rows
            n = (batch["labels"] != -1).sum().float()
            w = n / torch.clamp(_psum_axes(n, mesh, split), min=1.0)
            grads = torch.autograd.grad(loss * (w / copies), leaves,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            grads = shd.reduce_grads(grads, leaf_sh)
            gnorm = torch.sqrt(shd.global_sq_norm(grads, leaf_sh))
            params, opt_state, _ = adamw.apply(
                params, tree.unflatten(params, grads), opt_state, lr=lr,
                grad_norm=gnorm)
            total = _psum_axes(loss.detach() * w, mesh, split)
        return params, opt_state, total

    return train_step, (psh, osh, bsh), (psh, osh, rep), \
        (pstruct, ostruct, bstruct)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                       distributed: bool = True):
    """``fn(params, batch) -> (logits[:, -1:], caches)``: a data group's
    caches whole on each of its model ranks."""
    spec = _moe_spec(cfg, distributed)
    baxes = data_axes(mesh)
    pstruct = S.params_struct(cfg)
    bstruct = S.batch_struct(cfg, shape)
    psh = shd.param_shardings(pstruct, mesh, fsdp=needs_fsdp_infer(cfg))
    bsh = shd.batch_shardings(bstruct, mesh, baxes)
    layout = shd.Layout.of(psh, mesh)

    def prefill_step(params, batch):
        with torch.no_grad(), meshctx.with_mesh(mesh), \
                shd.with_layout(layout):
            logits, caches = api.prefill_fn(params, _indices(batch), cfg,
                                            shape.seq_len, spec=spec)
        # serving needs only the last position to start decoding
        return logits[:, -1:], caches

    B = shape.global_batch
    cstruct = api.init_decode_caches(pstruct, cfg, B, shape.seq_len,
                                     memory_len=shape.seq_len)
    logit_sh = shd.NamedSharding(mesh, shd.batch_spec(
        "logits", (B, 1, cfg.vocab_size), mesh, baxes))
    cache_sh = shd.cache_batch_shardings(cstruct, mesh, baxes)
    return prefill_step, (psh, bsh), (logit_sh, cache_sh), (pstruct, bstruct)


# ---------------------------------------------------------------------------
# serve (single-token decode against a full KV cache)
# ---------------------------------------------------------------------------


def build_serve_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     distributed: bool = True):
    """``fn(params, caches, token, cache_len) -> (logits, caches)``: one
    token for a data group's rows against its caches, held whole on each
    model rank (the reference's ``cache_spec`` splits the KV sequence over
    ``model``; the in/out shardings here are the ones the step uses)."""
    spec = _moe_spec(cfg, distributed)
    baxes = data_axes(mesh)
    fsdp_i = needs_fsdp_infer(cfg)
    pstruct = S.params_struct(cfg)
    cstruct, tstruct, lstruct = S.decode_structs(cfg, shape)
    psh = shd.param_shardings(pstruct, mesh, fsdp=fsdp_i)
    layout = shd.Layout.of(psh, mesh)

    def serve_step(params, caches, token, cache_len):
        with torch.no_grad(), meshctx.with_mesh(mesh), \
                shd.with_layout(layout):
            return api.decode_fn(params, token.long(), caches, cache_len,
                                 cfg, spec=spec, unshard=fsdp_i)

    csh = shd.cache_batch_shardings(cstruct, mesh, baxes)
    tsh = shd.batch_shardings({"token": tstruct, "cache_len": lstruct},
                              mesh, baxes)
    logit_sh = shd.NamedSharding(mesh, shd.batch_spec(
        "logits", (shape.global_batch, 1, cfg.vocab_size), mesh, baxes))
    in_sh = (psh, csh, tsh["token"], tsh["cache_len"])
    return serve_step, in_sh, (logit_sh, csh), \
        (pstruct, cstruct, tstruct, lstruct)


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, **kw):
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **kw)
    return build_serve_step(cfg, shape, mesh, **kw)

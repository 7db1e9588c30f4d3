"""Decoder-only LM assembly (port of ``repro.models.transformer``: the
dense, MoE, Mamba-2, hybrid attention/Mamba-2/MoE and vision-prefix
families; the encoder-decoder one is ``models.whisper``).

Layers are grouped into the smallest repeating period of identical
structure and each slot's parameters are stacked over periods, exactly
as in the reference, so the weight bridge is a leaf-for-leaf copy.  A
Python loop over periods replaces ``lax.scan``.  ``forward`` is the
full-sequence (scoring) pass; the serving engine runs the network
through ``prefill`` / ``prefill_chunk`` and, layer by layer or one span
between MoE boundaries at a time, the ``decode_*`` entry points;
``init_caches`` / ``decode_step`` are the one-token step on dense caches
(``api.decode_fn``).  The
engine's caches are a per-slot tuple of :class:`SlotCache`: attention
slots hold paged KV, SSM slots a dense per-row :class:`SSMState`, both
stacked over periods and written in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (resolve_device, resolve_init_device,
                                torch_dtype)
from repro_torch.parallel import sharding
from . import attention as attn_mod
from . import mamba2 as ssm_mod
from . import moe as moe_mod
from .layers import (apply_norm, checkpointed, dense_init, embed_init,
                     norm_init)
from .mlp import ffn, ffn_init


def period_plan(cfg: ModelConfig):
    """Smallest p dividing num_layers with kinds[i] == kinds[i mod p]."""
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    L = cfg.num_layers
    for p in range(1, L + 1):
        if L % p == 0 and all(kinds[i] == kinds[i % p] for i in range(L)):
            return p, kinds[:p]
    return L, kinds


def _check_supported(cfg: ModelConfig):
    """The encoder-decoder family runs through ``models.whisper``
    (``api`` dispatches), never through this module."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: use "
                         f"models.whisper (models.api dispatches to it)")


def _slot_init(gen, cfg: ModelConfig, mixer: str, ffn_kind: str,
               n_periods: int, device):
    dtype, lead = torch_dtype(cfg.dtype), (n_periods,)
    slot = {"norm1": norm_init(cfg.norm, cfg.d_model, device, lead)}
    if mixer == "attn":
        slot["attn"] = attn_mod.attn_init(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype, device, lead)
    else:
        slot["ssm"] = ssm_mod.mamba2_init(gen, cfg.d_model, cfg.ssm, dtype,
                                          device, lead)
    if ffn_kind != "none":
        slot["norm2"] = norm_init(cfg.norm, cfg.d_model, device, lead)
        if ffn_kind == "moe":
            slot["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.moe,
                                           cfg.activation, dtype, device, lead)
        else:
            slot["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                   dtype, device, lead)
    return slot


def init_lm(cfg: ModelConfig, *, generator: torch.Generator, device=None):
    """Random parameters: {"embed", "final_norm", "lm_head", "periods"}
    (``device="meta"``: their shapes and dtypes only)."""
    _check_supported(cfg)
    device = resolve_init_device(device)
    p, plan = period_plan(cfg)
    n_periods = cfg.num_layers // p
    dtype = torch_dtype(cfg.dtype)
    params = {"periods": tuple(_slot_init(generator, cfg, m, f, n_periods,
                                          device) for m, f in plan),
              "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, device),
              "final_norm": norm_init(cfg.norm, cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    return params


class SlotCache(NamedTuple):
    """Per-slot decode cache: attention KV (``ssm`` is ()) or an SSM state
    (``kv`` is ())."""
    kv: Any
    ssm: Any


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, device=None):
    """Per-slot tuple of SlotCache stacked over periods.  Attention slots
    hold KV pages (n_periods, num_pages + 1, page_size, n_kv, hd), the
    last page the sink of masked writes (``models.attention``), shared by
    every row through one page table; SSM slots a dense per-row
    SSMState (n_periods, batch, ...), which the state pool snapshots by
    value instead of paging it."""
    _check_supported(cfg)
    device = resolve_device(device)
    p, plan = period_plan(cfg)
    lead, dtype = (cfg.num_layers // p,), torch_dtype(cfg.dtype)
    caches = []
    for mixer, _ in plan:
        if mixer == "attn":
            caches.append(SlotCache(attn_mod.init_paged_kv_cache(
                num_pages, page_size, cfg.num_kv_heads,
                cfg.resolved_head_dim, dtype, device, lead=lead), ()))
        else:
            caches.append(SlotCache((), ssm_mod.init_ssm_state(
                batch, cfg.d_model, cfg.ssm, dtype, device, lead=lead)))
    return tuple(caches)


def _slot(period_params, c: int):
    """Parameters of period ``c`` out of one stacked slot dict."""
    if isinstance(period_params, dict):
        return {k: _slot(v, c) for k, v in period_params.items()}
    return period_params[c]


def _layer_params(params, s: int, c: int, gather: bool = False):
    """Slot ``s``'s parameters at period ``c``; ``gather``: gathered from
    the stored blocks of the sharding layout (the per-period ZeRO-3
    gather, ``parallel.sharding.unshard_slot_params``)."""
    slot = _slot(params["periods"][s], c)
    return sharding.unshard_slot_params(slot, f"periods/{s}") if gather \
        else slot


def layer_slots(params, cfg: ModelConfig, gather: bool = False):
    """(layer, slot parameters, mixer, ffn_kind) for every layer in order
    (``gather``: see :func:`_layer_params`)."""
    p, plan = period_plan(cfg)
    for c in range(cfg.num_layers // p):
        for s, (mixer, ffn_kind) in enumerate(plan):
            yield (c * p + s, _layer_params(params, s, c, gather), mixer,
                   ffn_kind)


def gathered(params, per_period: bool = False):
    """Under a sharding layout (``parallel.sharding.with_layout``), the
    parameters gathered whole from this rank's stored blocks (the MoE
    expert stacks stay split on ``model``, as the FSE-DP bodies take
    them); with ``per_period`` the period stacks are left stored, for the
    period bodies to gather one period at a time.  With no layout:
    ``params``."""
    if sharding.get_layout() is None:
        return params
    return {k: v if per_period and k == "periods"
            else sharding.gather_params(v, k) for k, v in params.items()}


def gathered_head(params):
    """The unembedding (d, V) gathered from the stored blocks (as
    :func:`head_matrix`, which it is with no layout)."""
    if "lm_head" in params:
        return sharding.gather_params(params["lm_head"], "lm_head")
    return sharding.gather_params(params["embed"], "embed").T


def _embed(params, tokens, prefix_embeds=None):
    """Token embeddings, with ``prefix_embeds`` (B, P, d) in front (a
    vision model's patch embeddings)."""
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def head_matrix(params):
    """The unembedding (d, V): ``lm_head``, or the tied embedding's
    transpose."""
    head = params.get("lm_head")
    return head if head is not None else params["embed"].T


def _unembed(params, x):
    return x @ head_matrix(params)


def _coerce_spec(spec):
    if spec is None:
        return None
    from repro_torch.core.strategy import ExecutionSpec
    return ExecutionSpec.coerce(spec)


def _apply_slot_full(slot, x, cfg: ModelConfig, mixer, ffn_kind, *,
                     positions, spec, layer, use_flash, ssd_kernel=False):
    """Full-sequence forward of one layer slot. Returns (x, aux).

    ``ssd_kernel`` sends an SSM mixer through the SSD kernel; ``forward``
    never sets it, as the reference's forward has no such switch."""
    h = apply_norm(cfg.norm, slot["norm1"], x)
    if mixer == "attn":
        h = attn_mod.attention(slot["attn"], h, n_heads=cfg.num_heads,
                               n_kv=cfg.num_kv_heads,
                               head_dim=cfg.resolved_head_dim,
                               rope_theta=cfg.rope_theta, positions=positions,
                               use_flash=use_flash)
    else:
        h = ssm_mod.mamba2_block(slot["ssm"], h, cfg.ssm, cfg.d_model,
                                 use_kernel=ssd_kernel)
    x = x + h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn_kind != "none":
        h = apply_norm(cfg.norm, slot["norm2"], x)
        if ffn_kind == "moe":
            h, aux = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation,
                                       spec=spec, phase="train", layer=layer,
                                       return_aux=True)
        else:
            h = ffn(slot["ffn"], h, cfg.activation)
        x = x + h
    return x, aux


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            spec=None, use_flash=False, remat=False, unshard=False,
            return_hidden=False):
    """tokens: (B, S) -> (logits (B, P + S, V) or, with ``return_hidden``,
    the final-normed hidden states (B, P + S, d); MoE aux loss summed over
    layers).  ``prefix_embeds`` (B, P, d) go in front of the tokens.

    ``spec``: MoE execution spec (strategy name / dict / ExecutionSpec),
    resolved per layer at phase ``train``.  ``use_flash``: attention
    through the flash kernel.  ``remat``: each period's activations are
    recomputed in the backward (the reference's ``jax.checkpoint`` of its
    period body).  Under a sharding layout (the mesh steps') the
    parameters are this rank's blocks: ``unshard`` gathers each period's
    inside the period body (so the remat recompute gathers again and no
    gathered period is saved), else the whole stack is gathered before
    the loop; the values are the same.  With no layout ``unshard`` does
    nothing, as in the reference."""
    _check_supported(cfg)
    p, plan = period_plan(cfg)
    sp = _coerce_spec(spec)
    params = gathered(params, per_period=unshard)
    x = _embed(params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def period(c, x, aux):
        for s, (mixer, ffn_kind) in enumerate(plan):
            x, a = _apply_slot_full(_layer_params(params, s, c, unshard),
                                    x, cfg, mixer, ffn_kind,
                                    positions=positions, spec=sp,
                                    layer=c * p + s, use_flash=use_flash)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(cfg.num_layers // p):
        x, aux = checkpointed(period, c, x, aux) if remat \
            else period(c, x, aux)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if return_hidden:
        return x, aux
    return _unembed(params, x), aux


def _stack_caches(per_slot):
    """Per-slot lists of per-period SlotCache -> stacked over periods."""
    out = []
    for entries in per_slot:
        kv, st = entries[0]
        if kv != ():
            out.append(SlotCache(attn_mod.KVCache(
                torch.stack([e.kv.k for e in entries]),
                torch.stack([e.kv.v for e in entries])), ()))
        else:
            out.append(SlotCache((), ssm_mod.SSMState(
                torch.stack([e.ssm.conv for e in entries]),
                torch.stack([e.ssm.ssd for e in entries]))))
    return tuple(out)


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, *,
            prefix_embeds=None, spec=None):
    """tokens: (B, S) -> (logits (B, S', V), caches stacked over periods:
    attention KV padded to max_seq, (n_periods, B, max_seq, n_kv, hd);
    SSM states (n_periods, B, ...)).  S' = P + S with ``prefix_embeds``
    (B, P, d) in front.  On CUDA the SSM layers' intra-chunk terms run
    through the SSD kernel.  Under a sharding layout the parameters are
    gathered from this rank's blocks first."""
    _check_supported(cfg)
    p, plan = period_plan(cfg)
    sp = _coerce_spec(spec)
    params = gathered(params)
    x = _embed(params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    per_slot = [[] for _ in plan]
    for layer, slot, mixer, ffn_kind in layer_slots(params, cfg):
        h = apply_norm(cfg.norm, slot["norm1"], x)
        if mixer == "attn":
            kv = attn_mod.prefill_kv(slot["attn"], h, n_kv=cfg.num_kv_heads,
                                     head_dim=cfg.resolved_head_dim,
                                     rope_theta=cfg.rope_theta,
                                     positions=positions)
            pad = (0, 0, 0, 0, 0, max_seq - S)
            per_slot[layer % p].append(SlotCache(attn_mod.KVCache(
                torch.nn.functional.pad(kv.k, pad),
                torch.nn.functional.pad(kv.v, pad)), ()))
            h = attn_mod.attention(slot["attn"], h, n_heads=cfg.num_heads,
                                   n_kv=cfg.num_kv_heads,
                                   head_dim=cfg.resolved_head_dim,
                                   rope_theta=cfg.rope_theta,
                                   positions=positions)
        else:
            h, st = ssm_mod.mamba2_prefill(slot["ssm"], h, cfg.ssm,
                                           cfg.d_model, use_kernel=h.is_cuda)
            per_slot[layer % p].append(SlotCache((), st))
        x = x + h
        if ffn_kind != "none":
            h = apply_norm(cfg.norm, slot["norm2"], x)
            if ffn_kind == "moe":
                h = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation,
                                      spec=sp, phase="prefill", layer=layer)
            else:
                h = ffn(slot["ffn"], h, cfg.activation)
            x = x + h
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x), _stack_caches(per_slot)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Empty dense decode caches, a SlotCache per slot stacked over
    periods: attention KV (n_periods, batch, max_seq, n_kv, hd), SSM
    states (n_periods, batch, ...)."""
    _check_supported(cfg)
    device = resolve_init_device(device)
    p, plan = period_plan(cfg)
    lead, dtype = (cfg.num_layers // p,), torch_dtype(cfg.dtype)
    caches = []
    for mixer, _ in plan:
        if mixer == "attn":
            caches.append(SlotCache(attn_mod.init_kv_cache(
                batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim,
                dtype, device, lead=lead), ()))
        else:
            caches.append(SlotCache((), ssm_mod.init_ssm_state(
                batch, cfg.d_model, cfg.ssm, dtype, device, lead=lead)))
    return tuple(caches)


def decode_step(params, token, caches, cache_len, cfg: ModelConfig, *,
                spec=None, unshard=False):
    """One token for every row against dense caches (``init_caches`` or
    ``prefill``).  token: (B, 1); cache_len: (B,) tokens cached, where
    the new one's K/V go.  Returns (logits (B, 1, V), new caches); the
    given caches are not modified.  ``unshard``: as :func:`forward`'s."""
    _check_supported(cfg)
    p, plan = period_plan(cfg)
    sp = _coerce_spec(spec)
    params = gathered(params, per_period=unshard)
    x = _embed(params, token)
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
    per_slot = [[] for _ in plan]
    for layer, slot, mixer, ffn_kind in layer_slots(params, cfg, unshard):
        c, s = divmod(layer, p)
        h = apply_norm(cfg.norm, slot["norm1"], x)
        if mixer == "attn":
            stack = caches[s].kv
            h, kv = attn_mod.attention_decode(
                slot["attn"], h, attn_mod.KVCache(stack.k[c], stack.v[c]),
                cache_len, **kw)
            per_slot[s].append(SlotCache(kv, ()))
        else:
            stack = caches[s].ssm
            h, st = ssm_mod.mamba2_decode(
                slot["ssm"], h, ssm_mod.SSMState(stack.conv[c], stack.ssd[c]),
                cfg.ssm, cfg.d_model)
            per_slot[s].append(SlotCache((), st))
        x = x + h
        if ffn_kind != "none":
            h = apply_norm(cfg.norm, slot["norm2"], x)
            if ffn_kind == "moe":
                h = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation,
                                      spec=sp, phase="decode", layer=layer)
            else:
                h = ffn(slot["ffn"], h, cfg.activation)
            x = x + h
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x), _stack_caches(per_slot)


def prefill_chunk(params, tokens, caches, cache_len, cfg: ModelConfig, *,
                  spec=None, token_mask=None, return_hidden=False,
                  page_table=None):
    """Append a K-token prompt chunk to the decode caches.

    tokens: (B, K); caches: per-slot SlotCache tuple, paged (written in
    place, with ``page_table`` (B, NP)) or dense (n_periods, B, S, n_kv,
    hd) (new stacks returned); an SSM slot's state advances through
    ``mamba2_chunk``, in place with a page table, else into a new stack;
    cache_len: (B,) tokens already cached; token_mask: (B, K) each row's
    valid chunk prefix (all-False rows leave their cache untouched, so
    decode and idle slots ride along).

    Returns (logits (B, K, V), caches, counts); with ``return_hidden`` the
    final-normed hidden states (B, K, d) come first instead.  ``counts``
    (n_periods, p, E) are per-layer expert activations over the valid
    tokens (layer L at ``counts[L // p, L % p]``, zero for non-MoE slots);
    each MoE layer is routed once and that routing drives the counts and
    the experts."""
    from repro_torch.core import gating
    _check_supported(cfg)
    p, plan = period_plan(cfg)
    sp = _coerce_spec(spec)
    x = _embed(params, tokens)
    B, K = tokens.shape
    if token_mask is None:
        token_mask = torch.ones((B, K), dtype=torch.bool, device=x.device)
    E = cfg.moe.num_experts if cfg.moe else 1
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
              token_mask=token_mask)
    counts, dense = [], [[] for _ in plan]
    for layer, slot, mixer, ffn_kind in layer_slots(params, cfg):
        c, s = divmod(layer, p)
        h = apply_norm(cfg.norm, slot["norm1"], x)
        if mixer == "attn":
            stack = caches[s].kv
            kv = attn_mod.KVCache(stack.k[c], stack.v[c])
            if page_table is not None:
                h, _ = attn_mod.attention_append_paged(
                    slot["attn"], h, kv, page_table, cache_len, **kw)
            else:
                h, kv = attn_mod.attention_append(slot["attn"], h, kv,
                                                  cache_len, **kw)
                dense[s].append(SlotCache(kv, ()))
        else:
            stack = caches[s].ssm
            h, st = ssm_mod.mamba2_chunk(
                slot["ssm"], h, ssm_mod.SSMState(stack.conv[c], stack.ssd[c]),
                cfg.ssm, cfg.d_model, token_mask=token_mask)
            if page_table is not None:
                stack.conv[c].copy_(st.conv)
                stack.ssd[c].copy_(st.ssd)
            else:
                dense[s].append(SlotCache((), st))
        x = x + h
        cnt = torch.zeros((E,), dtype=torch.int64, device=x.device)
        if ffn_kind != "none":
            h = apply_norm(cfg.norm, slot["norm2"], x)
            if ffn_kind == "moe":
                routing = gating.route(slot["moe"]["router"],
                                       h.reshape(-1, h.shape[-1]),
                                       top_k=cfg.moe.top_k)
                cnt = gating.expert_token_counts(routing,
                                                 token_mask.reshape(-1))
                h = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation,
                                      spec=sp, phase="prefill", layer=layer,
                                      routing=routing)
            else:
                h = ffn(slot["ffn"], h, cfg.activation)
            x = x + h
        counts.append(cnt)
    if page_table is None:
        caches = _stack_caches(dense)
    counts = torch.stack(counts).reshape(cfg.num_layers // p, p, E)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if return_hidden:
        return x, caches, counts
    return _unembed(params, x), caches, counts


# ---------------------------------------------------------------------------
# serving decode sub-steps (masked, one layer at a time)
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict = {}


def cached_period_plan(cfg: ModelConfig):
    hit = _PLAN_CACHE.get(cfg)
    if hit is None:
        hit = _PLAN_CACHE[cfg] = period_plan(cfg)
    return hit


def _layer_slot(params, layer: int, p: int):
    period_idx, slot = divmod(layer, p)
    return _slot(params["periods"][slot], period_idx)


def _merge(mask, new, old):
    return torch.where(mask[:, None, None], new, old)


def decode_embed_merge(params, x, token_vec, start_mask, cfg: ModelConfig):
    """Embed the fresh tokens of rows starting a pass; other rows keep
    their carried residual stream.  token_vec: (B,)."""
    emb = params["embed"][token_vec][:, None, :]
    return _merge(start_mask, emb, x)


def decode_mixer(params, x, caches, cache_len, cfg: ModelConfig, layer: int,
                 mask, page_table):
    """Masked one-token mixer step for one layer.  Only ``mask`` rows
    advance: an attention layer's new K/V land in the paged pool, an SSM
    layer's new state rows in its stacked state, in place (the fused
    segments' graphs replay fixed addresses); other rows keep their bits.
    Returns (x, caches)."""
    p, plan = cached_period_plan(cfg)
    period_idx, slot_i = divmod(layer, p)
    slot = _layer_slot(params, layer, p)
    h = apply_norm(cfg.norm, slot["norm1"], x)
    if plan[slot_i][0] == "ssm":
        stack = caches[slot_i].ssm
        old = ssm_mod.SSMState(stack.conv[period_idx], stack.ssd[period_idx])
        h, new = ssm_mod.mamba2_decode(slot["ssm"], h, old, cfg.ssm,
                                       cfg.d_model)
        for o, n in zip(old, new):
            o.copy_(torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)),
                                n, o))
        return _merge(mask, x + h, x), caches
    stack = caches[slot_i].kv
    pages = attn_mod.KVCache(stack.k[period_idx], stack.v[period_idx])
    h, _ = attn_mod.attention_decode_paged(
        slot["attn"], h, pages, page_table, cache_len, n_heads=cfg.num_heads,
        n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, row_mask=mask)
    return _merge(mask, x + h, x), caches


def decode_route(params, x, cfg: ModelConfig, layer: int, count_mask=None):
    """Route stage at one MoE boundary: (normed h, Routing, counts)."""
    from repro_torch.core import gating
    p, _ = cached_period_plan(cfg)
    slot = _layer_slot(params, layer, p)
    h = apply_norm(cfg.norm, slot["norm2"], x)
    routing = gating.route(slot["moe"]["router"], h[:, 0, :],
                           top_k=cfg.moe.top_k)
    counts = None
    if count_mask is not None:
        counts = gating.expert_token_counts(routing, count_mask)
    return h, routing, counts


def decode_moe_exec(params, x, h, routing, cfg: ModelConfig, layer: int,
                    mask, *, spec=None, schedule=None):
    """Dispatch + combine at one MoE boundary on the routed activations;
    merges the masked residual."""
    p, _ = cached_period_plan(cfg)
    slot = _layer_slot(params, layer, p)
    h = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation, spec=spec,
                          phase="decode", layer=layer, routing=routing,
                          schedule=schedule)
    return _merge(mask, x + h, x)


def decode_ffn(params, x, cfg: ModelConfig, layer: int, mask):
    """Masked dense-FFN sub-step (no-op for ffn_kind == 'none')."""
    p, plan = cached_period_plan(cfg)
    if plan[layer % p][1] == "none":
        return x
    slot = _layer_slot(params, layer, p)
    h = ffn(slot["ffn"], apply_norm(cfg.norm, slot["norm2"], x), cfg.activation)
    return _merge(mask, x + h, x)


def decode_span(params, x, caches, cache_len, cfg: ModelConfig, lo: int,
                hi: int, mask, page_table):
    """The non-MoE layers ``[lo, hi)`` (mixer and dense FFN each) for the
    masked rows: the body of a fused serving segment between MoE
    boundaries."""
    p, plan = cached_period_plan(cfg)
    for layer in range(lo, hi):
        assert plan[layer % p][1] != "moe", \
            f"layer {layer} is an MoE boundary, not span interior"
        x, caches = decode_mixer(params, x, caches, cache_len, cfg, layer,
                                 mask, page_table=page_table)
        x = decode_ffn(params, x, cfg, layer, mask)
    return x, caches


def decode_logits(params, x, cfg: ModelConfig):
    """Final norm + unembed of the carried (B, 1, d) residual stream."""
    return _unembed(params, apply_norm(cfg.norm, params["final_norm"], x))

"""Decoder-only LM assembly (port of ``repro.models.transformer``: the
attention + FFN/MoE and the Mamba-2 families).

Layers are grouped into the smallest repeating period of identical
structure and each slot's parameters are stacked over periods, exactly
as in the reference, so the weight bridge is a leaf-for-leaf copy.  A
Python loop over periods replaces ``lax.scan``.  ``forward`` is the
full-sequence (scoring) pass; the serving engine runs the network layer
by layer through ``prefill`` and the ``decode_*`` entry points, which
take attention stacks only.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from . import attention as attn_mod
from . import mamba2 as ssm_mod
from . import moe as moe_mod
from .layers import apply_norm, dense_init, embed_init, norm_init
from .mlp import ffn, ffn_init


def period_plan(cfg: ModelConfig):
    """Smallest p dividing num_layers with kinds[i] == kinds[i mod p]."""
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    L = cfg.num_layers
    for p in range(1, L + 1):
        if L % p == 0 and all(kinds[i] == kinds[i % p] for i in range(L)):
            return p, kinds[:p]
    return L, kinds


def _check_supported(cfg: ModelConfig, *, serving: bool = False):
    """Encoder-decoder models are not ported; SSM layers run in the
    full-sequence ``forward`` but not yet in the serving entry points."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models wait for ROADMAP A.13")
    if serving and any(m != "attn" for m in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: SSM layers in prefill, decode and the state pool "
            f"are not ported yet (ROADMAP A.13)")


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
    """Random parameters: {"embed", "final_norm", "lm_head", "periods"}."""
    _check_supported(cfg)
    device = resolve_device(device)
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
    """Per-slot decode cache; only attention KV (``ssm`` stays ())."""
    kv: Any
    ssm: Any


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int,
                      page_size: int, device=None):
    """Per-slot tuple of SlotCache with KV pages stacked over periods:
    (n_periods, num_pages, page_size, n_kv, hd)."""
    _check_supported(cfg, serving=True)
    device = resolve_device(device)
    p, plan = period_plan(cfg)
    n_periods = cfg.num_layers // p
    return tuple(SlotCache(attn_mod.init_paged_kv_cache(
        num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim,
        torch_dtype(cfg.dtype), device, lead=(n_periods,)), ())
        for _ in plan)


def _slot(period_params, c: int):
    """Parameters of period ``c`` out of one stacked slot dict."""
    if isinstance(period_params, dict):
        return {k: _slot(v, c) for k, v in period_params.items()}
    return period_params[c]


def layer_slots(params, cfg: ModelConfig):
    """(layer, slot parameters, mixer, ffn_kind) for every layer in order."""
    p, plan = period_plan(cfg)
    for c in range(cfg.num_layers // p):
        for s, (mixer, ffn_kind) in enumerate(plan):
            yield c * p + s, _slot(params["periods"][s], c), mixer, ffn_kind


def _embed(params, tokens):
    return params["embed"][tokens]


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


def forward(params, tokens, cfg: ModelConfig, *, spec=None, use_flash=False,
            return_hidden=False):
    """tokens: (B, S) -> (logits (B, S, V) or, with ``return_hidden``, the
    final-normed hidden states (B, S, d); MoE aux loss summed over layers).

    ``spec``: MoE execution spec (strategy name / dict / ExecutionSpec),
    resolved per layer at phase ``train``.  ``use_flash``: attention
    through the flash kernel."""
    _check_supported(cfg)
    sp = _coerce_spec(spec)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, slot, mixer, ffn_kind in layer_slots(params, cfg):
        x, a = _apply_slot_full(slot, x, cfg, mixer, ffn_kind,
                                positions=positions, spec=sp, layer=layer,
                                use_flash=use_flash)
        aux = aux + a
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if return_hidden:
        return x, aux
    return _unembed(params, x), aux


def prefill(params, tokens, cfg: ModelConfig, max_seq: int, *, spec=None):
    """tokens: (B, S) -> (logits (B, S, V), caches with KV padded to
    max_seq: per slot (n_periods, B, max_seq, n_kv, hd))."""
    _check_supported(cfg, serving=True)
    p, plan = period_plan(cfg)
    sp = _coerce_spec(spec)
    x = _embed(params, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    per_slot = [[] for _ in plan]
    for layer, slot, _, ffn_kind in layer_slots(params, cfg):
        h = apply_norm(cfg.norm, slot["norm1"], x)
        kv = attn_mod.prefill_kv(slot["attn"], h, n_kv=cfg.num_kv_heads,
                                 head_dim=cfg.resolved_head_dim,
                                 rope_theta=cfg.rope_theta,
                                 positions=positions)
        pad = (0, 0, 0, 0, 0, max_seq - S)
        per_slot[layer % p].append(attn_mod.KVCache(
            torch.nn.functional.pad(kv.k, pad),
            torch.nn.functional.pad(kv.v, pad)))
        h = attn_mod.attention(slot["attn"], h, n_heads=cfg.num_heads,
                               n_kv=cfg.num_kv_heads,
                               head_dim=cfg.resolved_head_dim,
                               rope_theta=cfg.rope_theta, positions=positions)
        x = x + h
        if ffn_kind != "none":
            h = apply_norm(cfg.norm, slot["norm2"], x)
            if ffn_kind == "moe":
                h = moe_mod.moe_block(slot["moe"], h, cfg.moe, cfg.activation,
                                      spec=sp, phase="prefill", layer=layer)
            else:
                h = ffn(slot["ffn"], h, cfg.activation)
            x = x + h
    caches = tuple(SlotCache(attn_mod.KVCache(torch.stack([kv.k for kv in kvs]),
                                              torch.stack([kv.v for kv in kvs])),
                             ()) for kvs in per_slot)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x), caches


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
    """Masked one-token attention step for one layer against the paged
    pool.  Only ``mask`` rows advance; their new K/V land in the pool in
    place.  Returns (x, caches)."""
    p, _ = cached_period_plan(cfg)
    period_idx, slot_i = divmod(layer, p)
    slot = _layer_slot(params, layer, p)
    h = apply_norm(cfg.norm, slot["norm1"], x)
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


def decode_logits(params, x, cfg: ModelConfig):
    """Final norm + unembed of the carried (B, 1, d) residual stream."""
    return _unembed(params, apply_norm(cfg.norm, params["final_norm"], x))

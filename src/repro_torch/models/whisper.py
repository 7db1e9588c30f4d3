"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``;
the conv frontend is a stub).

The caller supplies precomputed frame embeddings (B, F, d).  Encoder
layers are bidirectional self-attention + FFN; decoder layers add causal
self-attention with a dense KV cache and cross-attention over the
encoder memory, whose K/V ``init_decode_caches`` computes once.  Each
stack's parameters are stacked over its layers, as in the reference (the
weight bridge is a leaf-for-leaf copy), and a Python loop over the
layers replaces ``lax.scan``.  No TPU kernel is on this path: the
reference runs flash only for causal attention under ``use_flash``, which
Whisper never sets.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_init_device, torch_dtype
from . import attention as attn_mod
from .layers import (apply_norm, checkpointed, embed_init, norm_init,
                     sinusoidal_positions)
from .mlp import ffn, ffn_init
from .transformer import _slot as _layer


def _attn_init(gen, cfg, dtype, device, lead):
    return attn_mod.attn_init(gen, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim, dtype,
                              device, lead)


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator,
                device=None):
    """Random parameters: {"embed", "enc_layers", "dec_layers", "enc_norm",
    "dec_norm"}, each stack's leaves (n_layers, ...)."""
    device = resolve_init_device(device)
    dtype, d = torch_dtype(cfg.dtype), cfg.d_model
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "enc_layers": {
            "norm1": norm_init(cfg.norm, d, device, enc),
            "attn": _attn_init(generator, cfg, dtype, device, enc),
            "norm2": norm_init(cfg.norm, d, device, enc),
            "ffn": ffn_init(generator, d, cfg.d_ff, cfg.activation, dtype,
                            device, enc)},
        "dec_layers": {
            "norm1": norm_init(cfg.norm, d, device, dec),
            "self_attn": _attn_init(generator, cfg, dtype, device, dec),
            "norm_x": norm_init(cfg.norm, d, device, dec),
            "cross_attn": _attn_init(generator, cfg, dtype, device, dec),
            "norm2": norm_init(cfg.norm, d, device, dec),
            "ffn": ffn_init(generator, d, cfg.d_ff, cfg.activation, dtype,
                            device, dec)},
        "enc_norm": norm_init(cfg.norm, d, device),
        "dec_norm": norm_init(cfg.norm, d, device),
    }


def _heads(cfg: ModelConfig):
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim)


def encode(params, frames, cfg: ModelConfig, remat: bool = False):
    """frames: (B, F, d) precomputed embeddings -> memory (B, F, d).
    ``remat``: each layer's activations are recomputed in the backward."""
    F = frames.shape[1]
    x = frames + sinusoidal_positions(F, cfg.d_model, frames.device) \
        .to(frames.dtype)[None]

    def layer(i, x):
        lp = _layer(params["enc_layers"], i)
        h = apply_norm(cfg.norm, lp["norm1"], x)
        x = x + attn_mod.attention(lp["attn"], h, rope_theta=0.0,
                                   causal=False, **_heads(cfg))
        h = apply_norm(cfg.norm, lp["norm2"], x)
        return x + ffn(lp["ffn"], h, cfg.activation)

    for i in range(cfg.encoder_layers):
        x = checkpointed(layer, i, x) if remat else layer(i, x)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def decode_train(params, tokens, memory, cfg: ModelConfig,
                 remat: bool = False, return_hidden: bool = False):
    """Teacher-forced decoder. tokens: (B, S); memory: (B, F, d) -> logits
    (B, S, V), or the final-normed hidden states with ``return_hidden``.
    ``remat``: each layer's activations are recomputed in the backward."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]

    def layer(i, x, memory):
        lp = _layer(params["dec_layers"], i)
        h = apply_norm(cfg.norm, lp["norm1"], x)
        x = x + attn_mod.attention(lp["self_attn"], h, rope_theta=0.0,
                                   causal=True, **_heads(cfg))
        h = apply_norm(cfg.norm, lp["norm_x"], x)
        x = x + attn_mod.cross_attention(lp["cross_attn"], h, memory,
                                         **_heads(cfg))
        h = apply_norm(cfg.norm, lp["norm2"], x)
        return x + ffn(lp["ffn"], h, cfg.activation)

    for i in range(cfg.num_layers):
        x = checkpointed(layer, i, x, memory) if remat \
            else layer(i, x, memory)
    x = apply_norm(cfg.norm, params["dec_norm"], x)
    if return_hidden:
        return x
    return x @ params["embed"].T


class EncDecCaches(NamedTuple):
    self_kv: attn_mod.KVCache      # stacked (L, B, S, kv, hd)
    cross_k: torch.Tensor          # (L, B, F, kv, hd), from the memory
    cross_v: torch.Tensor


def init_decode_caches(params, memory, cfg: ModelConfig, batch, max_seq):
    """The cross-attention K/V of every decoder layer, computed once from
    ``memory`` (B, F, d), and an empty self-attention cache."""
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    kv = attn_mod.init_kv_cache(batch, max_seq, cfg.num_kv_heads, hd,
                                torch_dtype(cfg.dtype), memory.device,
                                lead=(L,))
    B, F = memory.shape[:2]
    cross = params["dec_layers"]["cross_attn"]
    ck = torch.stack([(memory @ cross["wk"][i]).reshape(
        B, F, cfg.num_kv_heads, hd) for i in range(L)])
    cv = torch.stack([(memory @ cross["wv"][i]).reshape(
        B, F, cfg.num_kv_heads, hd) for i in range(L)])
    return EncDecCaches(kv, ck, cv)


def decode_step(params, token, caches: EncDecCaches, cache_len,
                cfg: ModelConfig):
    """token: (B, 1); cache_len: (B,) -> (logits (B, 1, V), new caches);
    the given caches are not modified."""
    B = token.shape[0]
    hd = cfg.resolved_head_dim
    x = params["embed"][token]
    S = caches.self_kv.k.shape[2]
    pos_table = sinusoidal_positions(S, cfg.d_model, x.device)
    x = x + pos_table[torch.clamp(cache_len, max=S - 1)][:, None].to(x.dtype)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        h = apply_norm(cfg.norm, lp["norm1"], x)
        kv = attn_mod.KVCache(caches.self_kv.k[i], caches.self_kv.v[i])
        h, kv = attn_mod.attention_decode(lp["self_attn"], h, kv, cache_len,
                                          rope_theta=0.0, **_heads(cfg))
        ks.append(kv.k)
        vs.append(kv.v)
        x = x + h
        # cross-attention against the precomputed K/V
        h = apply_norm(cfg.norm, lp["norm_x"], x)
        q = (h @ lp["cross_attn"]["wq"]).reshape(B, 1, cfg.num_heads, hd)
        o = attn_mod._sdpa(
            q, attn_mod._repeat_kv(caches.cross_k[i], cfg.num_heads),
            attn_mod._repeat_kv(caches.cross_v[i], cfg.num_heads))
        x = x + o.reshape(B, 1, -1) @ lp["cross_attn"]["wo"]
        h = apply_norm(cfg.norm, lp["norm2"], x)
        x = x + ffn(lp["ffn"], h, cfg.activation)
    x = apply_norm(cfg.norm, params["dec_norm"], x)
    return x @ params["embed"].T, EncDecCaches(
        attn_mod.KVCache(torch.stack(ks), torch.stack(vs)), caches.cross_k,
        caches.cross_v)

"""GQA attention: full causal (prefill) and paged KV-cache decode (port of
``repro.models.attention``).

The reference's decode and prefill attention are plain einsums, not a
Pallas kernel, so they are plain PyTorch here too; the full-sequence
``attention(use_flash=True)`` of the scoring forward runs the flash
kernel (``kernels/flash_attention.py``).  Layouts stay the
reference's: activations (B, S, d), heads (B, S, H, hd), pages
(num_pages, page_size, n_kv, hd).  Unlike the reference, the paged
decode writes the new K/V into the page pool in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .layers import apply_rope, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S, n_kv, hd) dense, or (P, ps, n_kv, hd) pages
    v: torch.Tensor


def attn_init(gen, d_model, n_heads, n_kv, head_dim, dtype, device, lead=()):
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device, lead=lead),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device, lead=lead),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device, lead=lead),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device, lead=lead),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k, n_heads):
    """(B, S, n_kv, hd) -> (B, S, n_heads, hd) by group broadcast."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=-2)


def _sdpa(q, k, v, mask=None):
    """q: (B, Sq, H, hd), k/v: (B, Sk, H, hd); softmax in fp32."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, torch.tensor(NEG_INF,
                                                        device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(sq: int, sk: int, device):
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return (j <= i + (sk - sq))[None, None]                      # (1,1,Sq,Sk)


def attention(params, x, *, n_heads, n_kv, head_dim, rope_theta,
              positions=None, use_flash=False):
    """Full causal self-attention. x: (B, S, d).  ``use_flash`` runs the
    flash kernel through ``kernels.ops`` (the reference's oracle under
    ``use_kernels(False)``)."""
    B, S, _ = x.shape
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    k = _split_heads(x @ params["wk"], n_kv, head_dim)
    v = _split_heads(x @ params["wv"], n_kv, head_dim)
    if rope_theta:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    if use_flash:
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, kf, vf)
    else:
        out = _sdpa(q, kf, vf, causal_mask(S, S, x.device))
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]


def attention_decode(params, x, cache: KVCache, cache_len, *, n_heads, n_kv,
                     head_dim, rope_theta):
    """Single-token decode against a dense cache (not modified).

    x: (B, 1, d); cache k/v: (B, S, n_kv, hd); cache_len: (B,).  The new
    token's K/V go at index ``min(cache_len, S-1)`` of a copy.  Returns
    (out (B, 1, d), KVCache of the updated copies)."""
    B = x.shape[0]
    S = cache.k.shape[1]
    q = _split_heads(x @ params["wq"], n_heads, head_dim)         # (B,1,H,hd)
    k_new = _split_heads(x @ params["wk"], n_kv, head_dim)        # (B,1,kv,hd)
    v_new = _split_heads(x @ params["wv"], n_kv, head_dim)
    if rope_theta:
        pos = cache_len[:, None]
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    idx = torch.clamp(cache_len, max=S - 1)
    rows = torch.arange(B, device=x.device)
    k, v = cache.k.clone(), cache.v.clone()
    k[rows, idx] = k_new[:, 0].to(k.dtype)
    v[rows, idx] = v_new[:, 0].to(v.dtype)
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(head_dim)
    valid = torch.arange(S, device=x.device)[None, :] <= idx[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    out = out.reshape(B, 1, n_heads * head_dim) @ params["wo"]
    return out, KVCache(k, v)


def init_paged_kv_cache(num_pages, page_size, n_kv, head_dim, dtype, device,
                        lead=()):
    shape = (*lead, num_pages, page_size, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def gather_pages(pages: KVCache, page_table) -> KVCache:
    """Dense per-slot view (B, NP*page_size, n_kv, hd) of the page pool."""
    ps = pages.k.shape[1]
    B, NP = page_table.shape

    def dense(a):
        return a[page_table].reshape(B, NP * ps, *a.shape[2:])

    return KVCache(dense(pages.k), dense(pages.v))


def attention_decode_paged(params, x, pages: KVCache, page_table, cache_len,
                           *, n_heads, n_kv, head_dim, rope_theta, row_mask):
    """Single-token decode against the paged pool.

    Same math as :func:`attention_decode` on the gathered dense view;
    the new K/V of the ``row_mask`` rows are then written in place into
    ``(page_table[b, pos // ps], pos % ps)``; other rows write nothing.
    Returns (out, pages)."""
    B = x.shape[0]
    ps = pages.k.shape[1]
    S = page_table.shape[1] * ps
    out, nd = attention_decode(params, x, gather_pages(pages, page_table),
                               cache_len, n_heads=n_heads, n_kv=n_kv,
                               head_dim=head_dim, rope_theta=rope_theta)
    rows = torch.arange(B, device=x.device)
    idx = torch.clamp(cache_len, max=S - 1)
    m = torch.as_tensor(row_mask, device=x.device)
    rows, idx = rows[m], idx[m]
    phys = page_table[rows, idx // ps]
    pages.k[phys, idx % ps] = nd.k[rows, idx]
    pages.v[phys, idx % ps] = nd.v[rows, idx]
    return out, pages


def prefill_kv(params, x, *, n_kv, head_dim, rope_theta, positions=None):
    """Cache entries (rotary keys, values) for a full prompt."""
    S = x.shape[1]
    k = _split_heads(x @ params["wk"], n_kv, head_dim)
    v = _split_heads(x @ params["wv"], n_kv, head_dim)
    if rope_theta:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        k = apply_rope(k, positions, rope_theta)
    return KVCache(k, v)

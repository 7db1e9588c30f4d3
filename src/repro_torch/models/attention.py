"""GQA attention: full causal or bidirectional (prefill, encoders), cross
attention, and dense or paged KV-cache decode (port of
``repro.models.attention``).

The reference's decode and prefill attention are plain einsums, not a
Pallas kernel, so they are plain PyTorch here too; the full-sequence
``attention(use_flash=True)`` of the scoring forward runs the flash
kernel (``kernels/flash_attention.py``).  Layouts stay the
reference's: activations (B, S, d), heads (B, S, H, hd), pages
(num_pages, page_size, n_kv, hd).  Unlike the reference, the paged
decode and chunk append write the new K/V into the page pool in place.

The pool holds one page more than the state pool hands out: its last
page is a sink that no page-table entry names.  A masked row's write is
steered there (the reference drops it out of range, which torch cannot
index), so every write has a fixed shape, nothing syncs with the host
(the serving segments are captured as CUDA graphs), and an idle slot's
stale table row never writes through to a page another slot owns.
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
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(sq: int, sk: int, device):
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return (j <= i + (sk - sq))[None, None]                      # (1,1,Sq,Sk)


# above this length the query axis is taken QUERY_CHUNK rows at a time, so
# the live scores are (B, H, QUERY_CHUNK, Sk) instead of (B, H, S, Sk), as
# the reference's XLA path does for the 32k prefill cells
CHUNKED_THRESHOLD = 4096
QUERY_CHUNK = 1024


def _chunked_sdpa(q, k, v, *, causal: bool):
    """``_sdpa`` one QUERY_CHUNK of queries at a time (Sq a multiple of
    it); each chunk's softmax is over every key, so the values are
    ``_sdpa``'s."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    c = QUERY_CHUNK
    kpos = torch.arange(Sk, device=q.device)[None, :]
    out = []
    for i in range(Sq // c):
        qi = q[:, i * c:(i + 1) * c]
        s = torch.einsum("bqhd,bkhd->bhqk", qi, k).float() / math.sqrt(hd)
        if causal:
            qpos = i * c + torch.arange(c, device=q.device)[:, None]
            s = s.masked_fill(~(kpos <= qpos + (Sk - Sq))[None, None],
                              NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    return torch.cat(out, dim=1)


def attention(params, x, *, n_heads, n_kv, head_dim, rope_theta,
              positions=None, causal=True, use_flash=False):
    """Full self-attention, causal unless ``causal=False`` (an encoder).
    x: (B, S, d).  ``use_flash`` runs a causal call through the flash
    kernel (``kernels.ops``; the reference's oracle under
    ``use_kernels(False)``); a bidirectional one never, as in the
    reference.  At S >= CHUNKED_THRESHOLD (a multiple of QUERY_CHUNK) the
    plain path takes the queries a chunk at a time."""
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
    if use_flash and causal:
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, kf, vf)
    elif S >= CHUNKED_THRESHOLD and S % QUERY_CHUNK == 0:
        out = _chunked_sdpa(q, kf, vf, causal=causal)
    else:
        out = _sdpa(q, kf, vf, causal_mask(S, S, x.device) if causal else None)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]


def cross_attention(params, x, memory, *, n_heads, n_kv, head_dim):
    """x: (B, Sq, d) attends to memory (B, Sk, d); no rotary, no mask."""
    B, Sq, _ = x.shape
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    k = _split_heads(memory @ params["wk"], n_kv, head_dim)
    v = _split_heads(memory @ params["wv"], n_kv, head_dim)
    out = _sdpa(q, _repeat_kv(k, n_heads), _repeat_kv(v, n_heads))
    return out.reshape(B, Sq, n_heads * head_dim) @ params["wo"]


def init_kv_cache(batch, seq, n_kv, head_dim, dtype, device, lead=()):
    """An empty dense cache (…lead, batch, seq, n_kv, hd)."""
    shape = (*lead, batch, seq, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x, cache: KVCache, cache_len, *, n_heads, n_kv,
                     head_dim, rope_theta, update_cache: bool = True):
    """Single-token decode against a dense cache (not modified).

    x: (B, 1, d); cache k/v: (B, S, n_kv, hd); cache_len: (B,).  The new
    token's K/V go at index ``min(cache_len, S-1)`` of a copy; with
    ``update_cache=False`` the token attends over the cache as it is, its
    own K/V not written.  Returns (out (B, 1, d), KVCache of the updated
    copies, or of the cache's own tensors)."""
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
    k, v = cache.k, cache.v
    if update_cache:
        rows = torch.arange(B, device=x.device)
        k, v = k.clone(), v.clone()
        k[rows, idx] = k_new[:, 0].to(k.dtype)
        v[rows, idx] = v_new[:, 0].to(v.dtype)
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(head_dim)
    valid = torch.arange(S, device=x.device)[None, :] <= idx[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    out = out.reshape(B, 1, n_heads * head_dim) @ params["wo"]
    return out, KVCache(k, v)


def attention_append(params, x, cache: KVCache, cache_len, *, n_heads, n_kv,
                     head_dim, rope_theta, token_mask=None):
    """Chunked-prefill step: append a K-token chunk to a dense cache (not
    modified).

    x: (B, K, d); cache k/v: (B, S, n_kv, hd); cache_len: (B,) tokens
    already cached; ``token_mask`` (B, K) marks each row's valid chunk
    prefix.  Valid token i of row b lands at ``cache_len[b] + i`` and
    attends causally over everything at or before it; masked positions
    neither write nor become visible, so an all-False row's cache is
    bit-untouched.  Returns (out (B, K, d), KVCache of the updated
    copies)."""
    B, K, _ = x.shape
    S = cache.k.shape[1]
    q, k_new, v_new, pos, token_mask = _append_qkv(
        params, x, cache_len, token_mask, n_heads, n_kv, head_dim, rope_theta)
    # a dense cache has no sink: position by position, a masked (or
    # out-of-range) one rewrites what its clamped address holds by then
    write = token_mask & (pos < S)
    safe = torch.clamp(pos, max=S - 1)
    rows = torch.arange(B, device=x.device)
    k, v = cache.k.clone(), cache.v.clone()
    for i in range(K):
        m = write[:, i, None, None]
        k[rows, safe[:, i]] = torch.where(m, k_new[:, i].to(k.dtype),
                                          k[rows, safe[:, i]])
        v[rows, safe[:, i]] = torch.where(m, v_new[:, i].to(v.dtype),
                                          v[rows, safe[:, i]])
    return _append_attend(params, q, k, v, pos, n_heads, head_dim), \
        KVCache(k, v)


def _append_qkv(params, x, cache_len, token_mask, n_heads, n_kv, head_dim,
                rope_theta):
    """The chunk's rotary q, k and v at positions ``cache_len + i``, and
    the token mask (all True when not given)."""
    B, K, _ = x.shape
    q = _split_heads(x @ params["wq"], n_heads, head_dim)         # (B,K,H,hd)
    k_new = _split_heads(x @ params["wk"], n_kv, head_dim)
    v_new = _split_heads(x @ params["wv"], n_kv, head_dim)
    pos = cache_len[:, None] + torch.arange(K, device=x.device)[None, :]
    if rope_theta:
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    if token_mask is None:
        token_mask = torch.ones((B, K), dtype=torch.bool, device=x.device)
    return q, k_new, v_new, pos, token_mask


def _append_attend(params, q, k, v, pos, n_heads, head_dim):
    """Each chunk query attends over the keys at or before its position."""
    B, K = q.shape[:2]
    S = k.shape[1]
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() / math.sqrt(head_dim)
    valid = torch.arange(S, device=q.device)[None, None, :] \
        <= torch.clamp(pos, max=S - 1)[:, :, None]                 # (B,K,S)
    scores = scores.masked_fill(~valid[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.reshape(B, K, n_heads * head_dim) @ params["wo"]


def init_paged_kv_cache(num_pages, page_size, n_kv, head_dim, dtype, device,
                        lead=()):
    """``num_pages`` pages for the state pool plus the sink page last."""
    shape = (*lead, num_pages + 1, page_size, n_kv, head_dim)
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
    ``(page_table[b, pos // ps], pos % ps)``; the other rows' writes go to
    the sink page.  Returns (out, pages)."""
    B = x.shape[0]
    ps = pages.k.shape[1]
    S = page_table.shape[1] * ps
    out, nd = attention_decode(params, x, gather_pages(pages, page_table),
                               cache_len, n_heads=n_heads, n_kv=n_kv,
                               head_dim=head_dim, rope_theta=rope_theta)
    rows = torch.arange(B, device=x.device)
    idx = torch.clamp(cache_len, max=S - 1)
    m = torch.as_tensor(row_mask, device=x.device)
    phys = _steer(page_table[rows, idx // ps], m, pages)
    pages.k[phys, idx % ps] = nd.k[rows, idx]
    pages.v[phys, idx % ps] = nd.v[rows, idx]
    return out, pages


def _steer(phys, mask, pages: KVCache):
    """Physical pages of the writes, masked ones steered to the sink."""
    return torch.where(mask, phys, pages.k.shape[0] - 1)


def attention_append_paged(params, x, pages: KVCache, page_table, cache_len,
                           *, n_heads, n_kv, head_dim, rope_theta,
                           token_mask=None):
    """Chunked-prefill append against the paged pool.

    Same math as :func:`attention_append` on the gathered dense view; each
    valid chunk position ``pos = cache_len + i`` is written in place into
    ``(page_table[b, pos // ps], pos % ps)``, masked positions into the
    sink page.  Returns (out (B, K, d), pages)."""
    B = x.shape[0]
    ps = pages.k.shape[1]
    S = page_table.shape[1] * ps
    q, k_new, v_new, pos, token_mask = _append_qkv(
        params, x, cache_len, token_mask, n_heads, n_kv, head_dim, rope_theta)
    safe = torch.clamp(pos, max=S - 1)
    rows = torch.arange(B, device=x.device)[:, None]
    phys = _steer(page_table[rows, safe // ps], token_mask, pages)
    pages.k[phys, pos % ps] = k_new.to(pages.k.dtype)
    pages.v[phys, pos % ps] = v_new.to(pages.v.dtype)
    dense = gather_pages(pages, page_table)
    return _append_attend(params, q, dense.k, dense.v, pos, n_heads,
                          head_dim), pages


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

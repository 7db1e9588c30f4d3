"""Chunked prefill: port vs JAX on the CPU, fp32.

``attention_append`` / ``attention_append_paged`` and
``transformer.prefill_chunk`` (hidden states, caches, per-layer expert
counts) take the same numpy inputs as the JAX functions and agree within
1e-5 of the largest |want| (both accumulate in fp32, in other orders);
counts are integers and identical.  Appending a prompt in chunks of any
size gives ``prefill``'s logits, and a masked row never writes through
its (possibly stale) page-table row: the page it names stays bit-for-bit
as it was, in decode and in append.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import api, attention, transformer

ARCH = "granite-moe-1b-a400m"
TOL = 1e-5
H, KV, HD, D = 4, 2, 8, 32
THETA = 10_000.0


def _close(got, want, tol=TOL):
    got = bridge.to_numpy(got) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _attn_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for k, shape in (("wq", (D, H * HD)), ("wk", (D, KV * HD)),
                          ("wv", (D, KV * HD)), ("wo", (H * HD, D)))}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


KW = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=THETA)
CACHE_LEN = np.array([0, 3, 9], np.int64)
MASK = np.array([[True] * 4, [True, True, False, False], [False] * 4])


def _chunk(seed=1, B=3, K=4):
    return np.random.default_rng(seed).standard_normal((B, K, D)) \
        .astype(np.float32)


def test_attention_append_matches_reference():
    jp, tp = _attn_params()
    rng = np.random.default_rng(2)
    ck, cv = (rng.standard_normal((3, 16, KV, HD)).astype(np.float32)
              for _ in range(2))
    x = _chunk()
    want, jc = jattn.attention_append(
        jp, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
        jnp.asarray(CACHE_LEN, jnp.int32), token_mask=jnp.asarray(MASK), **KW)
    got, tc = attention.attention_append(
        tp, torch.from_numpy(x),
        attention.KVCache(torch.from_numpy(ck), torch.from_numpy(cv)),
        torch.from_numpy(CACHE_LEN), token_mask=torch.from_numpy(MASK), **KW)
    valid = MASK[..., None]                   # masked queries are garbage
    _close(np.where(valid, bridge.to_numpy(got), 0),
           np.where(valid, np.asarray(want), 0))
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert np.array_equal(bridge.to_numpy(tc.k[2]), ck[2])   # all-False row


def _paged(num_pages=12, ps=4, seed=3):
    rng = np.random.default_rng(seed)
    shape = (num_pages, ps, KV, HD)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], np.int64)
    sink = np.zeros((1, ps, KV, HD), np.float32)
    tpages = attention.KVCache(torch.from_numpy(np.concatenate([ck, sink])),
                               torch.from_numpy(np.concatenate([cv, sink])))
    jpages = jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv))
    return jpages, tpages, table


def test_attention_append_paged_matches_reference():
    jp, tp = _attn_params()
    jpages, tpages, table = _paged()
    x = _chunk()
    want, jnew = jattn.attention_append_paged(
        jp, jnp.asarray(x), jpages, jnp.asarray(table, jnp.int32),
        jnp.asarray(CACHE_LEN, jnp.int32), token_mask=jnp.asarray(MASK), **KW)
    got, tnew = attention.attention_append_paged(
        tp, torch.from_numpy(x), tpages, torch.from_numpy(table),
        torch.from_numpy(CACHE_LEN), token_mask=torch.from_numpy(MASK), **KW)
    valid = MASK[..., None]
    _close(np.where(valid, bridge.to_numpy(got), 0),
           np.where(valid, np.asarray(want), 0))
    n = jnew.k.shape[0]
    _close(tnew.k[:n], jnew.k)
    _close(tnew.v[:n], jnew.v)


def test_masked_rows_leave_other_slots_pages_untouched():
    """Row 2 is idle and its stale table row names pages slot 0 owns; its
    decode and append writes must land in the sink, not in those pages."""
    _, tp = _attn_params()
    _, pages, table = _paged()
    table[2] = table[0]                       # stale: slot 0's pages
    before = [t.clone() for t in pages]
    mask = torch.tensor([False, True, False])
    x1 = torch.from_numpy(_chunk(B=3, K=1))
    cl = torch.from_numpy(np.array([2, 3, 2], np.int64))
    attention.attention_decode_paged(tp, x1, pages, torch.from_numpy(table),
                                     cl, row_mask=mask, **KW)
    tmask = torch.from_numpy(np.array([[False] * 4, [True] * 4, [False] * 4]))
    attention.attention_append_paged(tp, torch.from_numpy(_chunk()), pages,
                                     torch.from_numpy(table), cl,
                                     token_mask=tmask, **KW)
    for new, old in zip(pages, before):
        for pid in table[0]:                  # slot 0's (and row 2's) pages
            assert torch.equal(new[pid], old[pid])
        assert not torch.equal(new[4:8], old[4:8])   # row 1 did write


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_chunk_matches_reference(model, paged):
    jcfg, cfg, jparams, params = model
    B, K, ps, NP = 3, 4, 4, 4
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, K))
    cl = np.array([0, 4, 2], np.int64)
    table = np.arange(B * NP, dtype=np.int64).reshape(B, NP)
    p, plan = transformer.period_plan(cfg)
    n_periods = cfg.num_layers // p
    shape = (n_periods, B * NP + 1 if paged else B, ps if paged else NP * ps,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    # the history before the chunk, the same on both sides (a paged
    # pool's last page is the port's sink, which JAX does not have)
    tc = tuple(transformer.SlotCache(attention.KVCache(*(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for _ in range(2))), ()) for _ in plan)
    cut = slice(0, -1) if paged else slice(None)
    jc = tuple(c._replace(kv=jattn.KVCache(*(
        jnp.asarray(bridge.to_numpy(a[:, cut])) for a in t.kv)))
        for c, t in zip(jtf.init_paged_caches(jcfg, B, B * NP, ps), tc))
    jkw, tkw = {}, {}
    if paged:
        jkw = dict(page_table=jnp.asarray(table, jnp.int32))
        tkw = dict(page_table=torch.from_numpy(table))
    jh, jnew, jcnt = jtf.prefill_chunk(
        jparams, jnp.asarray(tokens, jnp.int32), jc,
        jnp.asarray(cl, jnp.int32), jcfg, spec="capacity",
        token_mask=jnp.asarray(MASK), return_hidden=True, **jkw)
    with torch.no_grad():
        th, tnew, tcnt = api.prefill_chunk_fn(
            params, torch.from_numpy(tokens), tc, torch.from_numpy(cl), cfg,
            spec="capacity", token_mask=torch.from_numpy(MASK),
            return_hidden=True, **tkw)
    valid = MASK[..., None]
    _close(np.where(valid, bridge.to_numpy(th), 0),
           np.where(valid, np.asarray(jh), 0))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tcnt.sum() == MASK.sum() * cfg.moe.top_k * cfg.num_layers
    for jcache, tcache in zip(jnew, tnew):
        for ja, ta in zip(jcache.kv, tcache.kv):
            _close(ta[:, :ja.shape[1]], ja)


@pytest.mark.parametrize("K", [1, 3, 16])
def test_chunk_partition_invariance(model, K):
    """The prompt appended K tokens at a time gives ``prefill``'s logits
    at every position, and its counts sum to the same total whatever K."""
    _, cfg, _, params = model
    # drop-free capacity (C = T*k), as the engine serves: which tokens a
    # finite capacity drops depends on the chunk's other tokens
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 16)
    ps, NP = 4, 6
    with torch.no_grad():
        want, _ = transformer.prefill(params, torch.from_numpy(prompt)[None],
                                      cfg, NP * ps, spec="capacity")
        caches = transformer.init_paged_caches(cfg, 1, NP, ps, device="cpu")
        table = torch.arange(NP)[None]
        got, total = [], 0
        for s0 in range(0, len(prompt), K):
            chunk = prompt[s0:s0 + K]
            logits, caches, cnt = transformer.prefill_chunk(
                params, torch.from_numpy(chunk)[None], caches,
                torch.tensor([s0]), cfg, spec="capacity", page_table=table)
            got.append(logits)
            total += int(cnt.sum())
    _close(torch.cat(got, 1), want)
    assert total == len(prompt) * cfg.moe.top_k * cfg.num_layers

"""Model entry points: port vs JAX on reduced granite-moe-1b-a400m, CPU.

The same weights (JAX init, bridged leaf for leaf) and the same tokens go
through both packages.  fp32: prefill logits and KV caches, and every
sub-step of one paged decode iteration (mixer, route, moe_exec, logits)
and the updated pages, agree within 1e-4 (both accumulate in fp32, in
different orders); routed expert ids are identical.  bf16: prefill
logits agree within 3e-2 of the largest logit (about 1e-2 seen) — bf16
rounds after every matmul, at places that differ between XLA and
PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.serving import statepool as jpool
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import api, transformer
from repro_torch.serving import statepool

ARCH = "granite-moe-1b-a400m"
TOL = 1e-4
BF16_TOL = 3e-2


def _setup(dtype="float32"):
    jcfg = jreduced(ARCH).replace(dtype=dtype)
    cfg = reduced_config(ARCH).replace(dtype=dtype)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _np(t):
    return bridge.to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_configs_match_reference():
    jcfg, cfg = jreduced(ARCH), reduced_config(ARCH)
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for a, b in ((jcfg, cfg), (jget(ARCH), get_config(ARCH))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "activation", "norm",
                  "rope_theta", "dtype"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.moe.__dict__ == b.moe.__dict__
        assert a.param_count() == b.param_count()
        assert jtf.period_plan(a) == transformer.period_plan(b)


@pytest.mark.parametrize("B,S", [(1, 6), (2, 5)])
def test_prefill_matches_reference(B, S):
    jcfg, cfg, jparams, params = _setup()
    tokens = np.random.default_rng(B).integers(0, cfg.vocab_size, (B, S))
    with jops.use_kernels(False):
        jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)},
                                 jcfg, 16, spec="capacity")
    with torch.no_grad():
        tl, tc = api.prefill_fn(params, {"tokens": torch.from_numpy(tokens)},
                                cfg, 16, spec="capacity")
    assert tuple(tl.shape) == (B, S, cfg.vocab_size)
    _close(tl, jl)
    for c, jc_ in zip(tc, jc):
        _close(c.kv.k, jc_.kv.k)
        _close(c.kv.v, jc_.kv.v)


def test_prefill_bf16_matches_reference():
    jcfg, cfg, jparams, params = _setup("bfloat16")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 8))
    with jops.use_kernels(False):
        jl, _ = japi.prefill_fn(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg, 16, spec="capacity")
    with torch.no_grad():
        tl, _ = api.prefill_fn(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, 16, spec="capacity")
    assert tl.dtype == torch.bfloat16
    jl = np.asarray(jl, np.float32)
    err = np.abs(_np(tl) - jl).max() / np.abs(jl).max()
    assert err <= BF16_TOL, err


@pytest.mark.parametrize("row_mask", [(True, True), (True, False)])
def test_paged_decode_step_matches_reference(row_mask):
    jcfg, cfg, jparams, params = _setup()
    ps, max_ctx = 4, 16
    prompts = [[5, 9, 2, 77, 31], [100, 3, 64]]
    pages = [[0, 1], [2]]
    table = np.zeros((2, max_ctx // ps), np.int32)
    table[0, :2], table[1, :1] = pages[0], pages[1]
    jcaches = jtf.init_paged_caches(jcfg, 2, 8, ps)
    caches = transformer.init_paged_caches(cfg, 2, 8, ps, device="cpu")
    first = []
    with torch.no_grad(), jops.use_kernels(False):
        for slot, prompt in enumerate(prompts):
            jl, jc1 = japi.prefill_fn(
                jparams, {"tokens": jnp.asarray([prompt])}, jcfg, max_ctx,
                spec="capacity")
            tl, tc1 = api.prefill_fn(
                params, {"tokens": torch.as_tensor([prompt])}, cfg, max_ctx,
                spec="capacity")
            jcaches = jpool.merge_prefill(jcaches, jc1, pages[slot], slot, ps)
            statepool.merge_prefill(caches, tc1, pages[slot], slot, ps)
            first.append(int(np.asarray(jl[0, -1]).argmax()))
            assert int(tl[0, -1].argmax()) == first[-1]
        cl = np.array([len(p) for p in prompts])
        mask = np.array(row_mask)
        jx = japi.decode_embed_merge(jparams, jnp.zeros((2, 1, cfg.d_model)),
                                     jnp.asarray(first), jnp.ones(2, bool),
                                     jcfg)
        x = api.decode_embed_merge(params, torch.zeros(2, 1, cfg.d_model),
                                   torch.as_tensor(first),
                                   torch.ones(2, dtype=torch.bool), cfg)
        _close(x, jx)
        jt, tt = jnp.asarray(table), torch.as_tensor(table, dtype=torch.int64)
        for layer in range(cfg.num_layers):
            jx, jcaches = japi.decode_mixer(jparams, jx, jcaches,
                                            jnp.asarray(cl), jcfg, layer,
                                            jnp.asarray(mask), page_table=jt)
            x, caches = api.decode_mixer(params, x, caches, torch.from_numpy(cl),
                                         cfg, layer, torch.from_numpy(mask),
                                         page_table=tt)
            _close(x, jx)
            jh, jr, jcnt = japi.decode_route(jparams, jx, jcfg, layer,
                                             count_mask=jnp.asarray(mask))
            h, r, cnt = api.decode_route(params, x, cfg, layer,
                                         count_mask=torch.from_numpy(mask))
            np.testing.assert_array_equal(r.indices.numpy(),
                                          np.asarray(jr.indices))
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
            jx = japi.decode_moe_exec(jparams, jx, jh, jr, jcfg, layer,
                                      jnp.asarray(mask), spec="capacity")
            x = api.decode_moe_exec(params, x, h, r, cfg, layer,
                                    torch.from_numpy(mask), spec="capacity")
            _close(x, jx)
        _close(api.decode_logits(params, x, cfg),
               japi.decode_logits(jparams, jx, jcfg))
    for c, jc_ in zip(caches, jcaches):     # the port's sink page is last
        _close(c.kv.k[:, :-1], jc_.kv.k)
        _close(c.kv.v[:, :-1], jc_.kv.v)

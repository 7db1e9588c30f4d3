"""The scoring forward and loss: port vs JAX on the CPU.

Reduced granite-moe-1b-a400m (MoE strategy ``capacity``, attention
through the flash kernel on both sides: Pallas in interpret mode, the
port's plain version) and reduced mamba2-370m, fp32, the same weights
(JAX init, bridged leaf for leaf) and tokens: ``transformer.forward``
logits and hidden states, the MoE aux loss and ``api.loss_fn`` agree
within 1e-4 (both accumulate in fp32, in other orders).  ``loss_fn`` is
forward only and raises under autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import api as japi
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import api, transformer

TOL = 1e-4
CASES = [("granite-moe-1b-a400m", "capacity", True),
         ("mamba2-370m", None, False)]


def _setup(arch):
    jcfg = jreduced(arch).replace(dtype="float32")
    cfg = reduced_config(arch).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    return tokens, labels


def _close(a, b):
    np.testing.assert_allclose(bridge.to_numpy(a), np.asarray(b, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,spec,use_flash", CASES)
def test_forward_and_loss_match_reference(arch, spec, use_flash):
    jcfg, cfg, jparams, params = _setup(arch)
    tokens, labels = _batch(cfg, 2, 64, seed=1)
    jl, jaux = jtf.forward(jparams, jnp.asarray(tokens), jcfg, spec=spec,
                           use_flash=use_flash)
    jloss, jm = japi.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)},
                             jcfg, spec=spec, use_flash=use_flash)
    t, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    with torch.no_grad():
        logits, aux = transformer.forward(params, t, cfg, spec=spec,
                                          use_flash=use_flash)
        h, aux_h = transformer.forward(params, t, cfg, spec=spec,
                                       use_flash=use_flash, return_hidden=True)
        loss, m = api.loss_fn(params, {"tokens": t, "labels": lab}, cfg,
                              spec=spec, use_flash=use_flash)
    assert tuple(logits.shape) == (2, 64, cfg.vocab_size)
    assert tuple(h.shape) == (2, 64, cfg.d_model)
    _close(logits, jl)
    _close(aux, jaux)
    _close(aux_h, jaux)
    _close(loss, jloss)
    _close(m["ce"], jm["ce"])
    _close(m["aux"], jm["aux"])
    if cfg.moe is None:
        assert float(aux) == 0.0


def test_fused_xent_chunks_match_one_pass():
    """A ragged tail (S = 2 chunks + 7) and ignored labels: the chunked
    loss equals the unchunked one."""
    rng = np.random.default_rng(2)
    S = 2 * api.CE_CHUNK + 7
    h = torch.from_numpy(rng.standard_normal((2, S, 16)).astype(np.float32))
    head = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(-1, 40, (2, S)))
    tot, cnt = api._xent(h @ head, labels)
    got = api.fused_xent(h, head, labels)
    np.testing.assert_allclose(got.item(), (tot / cnt).item(), rtol=1e-6)
    want = japi.fused_xent(jnp.asarray(h.numpy()), jnp.asarray(head.numpy()),
                           jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)


def test_loss_fn_raises_under_autograd():
    _, cfg, _, params = _setup("mamba2-370m")
    tokens, labels = _batch(cfg, 1, 32, seed=0)
    params["embed"].requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    with pytest.raises(NotImplementedError, match="A.15"):
        api.loss_fn(params, batch, cfg)
    with torch.no_grad():
        loss, _ = api.loss_fn(params, batch, cfg)
    assert torch.isfinite(loss)

"""Whisper (the encoder-decoder family): port vs JAX on the CPU.

Reduced whisper-base in fp32, the reference's weights bridged leaf for
leaf (``enc_layers`` / ``dec_layers`` stacked, layernorm ``scale`` and
``bias``), the same frames and tokens: ``encode``, ``decode_train``,
``api.loss_fn``, ``api.prefill_fn`` and 8 ``api.decode_fn`` steps agree
within 1e-4 (tests/test_torch_forward.py's fp32 tolerance); the ports of
the reference's ``tests/test_whisper.py`` (the decode chain equals teacher
forcing at its 2e-3, the encoder is bidirectional); chunked prefill and
the engine refuse the family, and so does ``serve --arch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import api as japi
from repro.models import whisper as jwhisper
from repro_torch import bridge, tree
from repro_torch.configs import reduced_config
from repro_torch.launch import serve
from repro_torch.models import api, transformer, whisper
from repro_torch.serving import Engine, ServeConfig

ARCH = "whisper-base"
TOL = 1e-4            # fp32 model outputs
TF_TOL = 2e-3         # decode chain vs teacher forcing (tests/test_whisper.py)
B, F, S = 2, 12, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _inputs(cfg, seed=0, n_tok=S):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, n_tok))
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    return frames, tokens, labels


def test_bridge_copies_the_whisper_tree(model):
    """Every reference leaf, bit for bit, at the same path; the port's own
    init draws the same tree (keys, shapes, dtypes)."""
    jcfg, cfg, jparams, params = model
    flat = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(flat) == len(tree.leaves(params))
    for path, leaf in flat.items():
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(bridge.to_numpy(node),
                                      np.asarray(leaf, np.float32))
    assert tuple(params["enc_layers"]["norm1"]["bias"].shape) == \
        (cfg.encoder_layers, cfg.d_model)
    own = api.init_params(cfg, seed=0, device="cpu")
    assert sorted((k, tuple(t.shape), t.dtype) for k, t in tree.leaves_with_path(own)) \
        == sorted((k, tuple(t.shape), t.dtype)
                  for k, t in tree.leaves_with_path(params))


def test_encode_and_decode_train_match_reference(model):
    jcfg, cfg, jparams, params = model
    frames, tokens, _ = _inputs(cfg)
    jmem = jwhisper.encode(jparams, jnp.asarray(frames), jcfg)
    jlog = jwhisper.decode_train(jparams, jnp.asarray(tokens), jmem, jcfg)
    jh = jwhisper.decode_train(jparams, jnp.asarray(tokens), jmem, jcfg,
                               return_hidden=True)
    with torch.no_grad():
        mem = whisper.encode(params, torch.from_numpy(frames), cfg)
        logits = whisper.decode_train(params, torch.from_numpy(tokens), mem,
                                      cfg)
        h = whisper.decode_train(params, torch.from_numpy(tokens), mem, cfg,
                                 return_hidden=True)
    assert tuple(mem.shape) == (B, F, cfg.d_model)
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    _close(mem, jmem)
    _close(logits, jlog)
    _close(h, jh)


def test_loss_fn_matches_reference(model):
    jcfg, cfg, jparams, params = model
    frames, tokens, labels = _inputs(cfg, seed=1)
    jloss, jm = japi.loss_fn(jparams, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)}, jcfg)
    with torch.no_grad():
        loss, m = api.loss_fn(params, {"frames": torch.from_numpy(frames),
                                       "tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)},
                              cfg)
    _close(loss, jloss)
    _close(m["ce"], jm["ce"])
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def test_prefill_and_decode_fn_match_reference(model):
    """``prefill_fn`` (teacher-forced logits, the cross K/V, an empty self
    cache, as the reference), then 8 ``decode_fn`` steps from position 0:
    logits and the self-attention cache against the reference's each
    step."""
    jcfg, cfg, jparams, params = model
    frames, tokens, _ = _inputs(cfg, seed=2, n_tok=8)
    batch = {"frames": frames, "tokens": tokens[:, :3]}
    jl, jc = japi.prefill_fn(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, jcfg, 16)
    with torch.no_grad():
        logits, caches = api.prefill_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
            16)
        _close(logits, jl)
        _close(caches.cross_k, jc.cross_k)
        _close(caches.cross_v, jc.cross_v)
        assert not caches.self_kv.k.any()
        for t in range(8):
            tok = tokens[:, t:t + 1]
            lg, caches = api.decode_fn(params, torch.from_numpy(tok), caches,
                                       torch.full((B,), t), cfg)
            jlg, jc = japi.decode_fn(jparams, jnp.asarray(tok), jc,
                                     jnp.full((B,), t, jnp.int32), jcfg)
            _close(lg, jlg)
            _close(caches.self_kv.k, jc.self_kv.k)
            _close(caches.self_kv.v, jc.self_kv.v)


def test_decode_matches_teacher_forcing(model):
    """The reference's ``tests/test_whisper.py`` check on the port."""
    _, cfg, _, params = model
    frames, tokens, _ = _inputs(cfg, seed=3)
    with torch.no_grad():
        memory = whisper.encode(params, torch.from_numpy(frames), cfg)
        logits_tf = whisper.decode_train(params, torch.from_numpy(tokens),
                                         memory, cfg)
        caches = whisper.init_decode_caches(params, memory, cfg, B,
                                            max_seq=16)
        outs = []
        for t in range(S):
            lg, caches = whisper.decode_step(
                params, torch.from_numpy(tokens[:, t:t + 1]), caches,
                torch.full((B,), t), cfg)
            outs.append(lg)
    _close(torch.cat(outs, 1), logits_tf.numpy(), TF_TOL)


def test_encoder_bidirectional(model):
    """Encoder output at position 0 depends on later frames."""
    _, cfg, _, params = model
    frames = torch.from_numpy(_inputs(cfg, seed=4)[0][:1, :8])
    moved = frames.clone()
    moved[0, 7] = 5.0
    with torch.no_grad():
        m1 = whisper.encode(params, frames, cfg)
        m2 = whisper.encode(params, moved, cfg)
    assert not torch.allclose(m1[0, 0], m2[0, 0], atol=1e-6)


def test_init_decode_caches_default_memory(model):
    """``api.init_decode_caches``: a zero memory of 1500 frames (the 30 s
    window), as the reference."""
    jcfg, cfg, jparams, params = model
    caches = api.init_decode_caches(params, cfg, 2, 10)
    jc = japi.init_decode_caches(jparams, jcfg, 2, 10)
    assert tuple(caches.cross_k.shape) == jc.cross_k.shape == \
        (cfg.num_layers, 2, 1500, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert tuple(caches.self_kv.k.shape) == jc.self_kv.k.shape
    _close(caches.cross_k, jc.cross_k)


def test_lm_paths_refuse_the_family(model, capsys):
    _, cfg, _, params = model
    with pytest.raises(NotImplementedError, match="LM-family"):
        api.prefill_chunk_fn(params, None, None, None, cfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        transformer.init_lm(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(AssertionError, match="LM-family"):
        Engine(params, cfg, ServeConfig(), device="cpu")
    with pytest.raises(SystemExit, match="engine serves LM-family models"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--dry-run"])

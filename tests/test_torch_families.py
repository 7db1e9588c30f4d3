"""The rest of the model families: port vs JAX on the CPU.

* every registered config, full and ``reduced()``, field for field (``==``),
  with its parameter counts, layer and FFN kinds, period plan and shape
  cells; the registry and ``configs/shapes.py``;
* ``layernorm`` (fp32 statistics) at 1e-6 and ``sinusoidal_positions``
  with ``==``;
* ``attention`` with ``causal=False``, the chunked path at S = 4096 (small
  widths; causal and not) and ``cross_attention`` at fp32 1e-4;
* reduced InternVL2 with prefix embeddings: ``forward``, ``loss_fn`` (only
  the text positions scored) and ``prefill`` at 1e-4, attention through the
  flash kernel (Pallas in interpret mode, the port's plain version);
* ``init_caches`` + ``decode_step`` and ``decode_fn`` on reduced granite and
  Qwen3 (after a prefill, four steps) at 1e-4, and decode == the
  teacher-forced forward (under ``dense``: capacity drops differ);
* the scoring forward of every other new LM family (the paper's Table I
  MoE models, Phi-3.5, the dense ones with layernorm, relu2 or MHA) at
  1e-4, Nemotron-4-340B narrowed around its head_dim of 192 through flash
  (Pallas in interpret mode, the port's plain version) at 1e-4, and
  DeepSeek's MoE block with its shared experts at 2e-5;
* the engine on reduced DeepSeek (two shared experts a layer: one in
  reduced) and reduced Qwen3 in fp32, ``submit`` and ``submit_chunked``,
  and on reduced Nemotron-4-340B (dense: no MoE boundary, one host sync an
  iteration; 2 requests x 8 -> 8 tokens), fused and eager: tokens, the
  trace with ``modeled_s`` and the statistics equal to the reference
  engine's (run once per module, ``use_kernels(False)``);
* ``serve --arch`` dry runs of the new MoE archs on ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPE_ORDER as JSHAPE_ORDER
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import (SHAPE_ORDER, SHAPES, cells, get_config,
                                 list_configs, reduced_config)
from repro_torch.launch import serve
from repro_torch.models import api, attention, layers, moe, transformer
from repro_torch.serving import Engine, ServeConfig

TOL = 1e-4             # fp32 model outputs (tests/test_torch_forward.py)
MOE_TOL = 2e-5         # the MoE block
NORM_TOL = 1e-6
ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m", "internvl2-2b",
         "jamba-v0.1-52b", "mamba2-370m", "nemotron-4-15b",
         "nemotron-4-340b", "phi3.5-moe-42b-a6.6b", "qwen3-30b-a3b",
         "stablelm-1.6b", "whisper-base", "yi-6b", "yuan2-m32")
DEEPSEEK, QWEN, VLM = "deepseek-moe-16b", "qwen3-30b-a3b", "internvl2-2b"
NEMOTRON = "nemotron-4-340b"
CAPACITY = {"strategy": "capacity"}
# Nemotron-4-340B narrowed around its head_dim of 192 (2 heads, 1 KV head),
# whose scoring forward runs through flash at hd 192
NEMOTRON_HD192 = "nemotron-4-340b@hd192"
HD192 = dict(num_layers=2, d_model=384, num_heads=2, num_kv_heads=1,
             d_ff=256, vocab_size=128, dtype="float32")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _setup(arch, seed=0):
    if arch == NEMOTRON_HD192:
        jcfg, cfg = jget(NEMOTRON).replace(**HD192), \
            get_config(NEMOTRON).replace(**HD192)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim == 192
    else:
        jcfg = jreduced(arch).replace(dtype="float32")
        cfg = reduced_config(arch).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _tokens(cfg, B, S, seed):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1)], axis=1)
    return tokens, labels


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------


def test_registry_and_shapes_match_reference():
    assert list_configs() == jlist() == sorted(ARCHS)
    assert SHAPE_ORDER == JSHAPE_ORDER
    assert {k: v.__dict__ for k, v in SHAPES.items()} == \
        {k: v.__dict__ for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Full and reduced, field for field (sub-configs included), and every
    derived quantity the port computes."""
    for jc, c in ((jget(arch), get_config(arch)),
                  (jreduced(arch), reduced_config(arch))):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encoder_decoder",
                     "is_attention_free", "has_moe", "supports_long_context",
                     "has_decode"):
            assert getattr(c, prop) == getattr(jc, prop), prop
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
        assert c.layer_kinds() == jc.layer_kinds()
        assert c.ffn_kinds() == jc.ffn_kinds()
        assert transformer.period_plan(c) == jtf.period_plan(jc)
        assert [(s.__dict__, ok, why) for s, ok, why in cells(c)] == \
            [(s.__dict__, ok, why) for s, ok, why in jcells(jc)]


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_reference(dtype):
    x = np.asarray(jnp.asarray(_rand((3, 5, 24), 0) * 3 + 1, dtype))
    p = {"scale": _rand((24,), 1), "bias": _rand((24,), 2)}
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           bridge.to_tensor(x, "cpu"))
    assert got.dtype == bridge.to_tensor(x, "cpu").dtype
    tol = NORM_TOL if dtype == jnp.float32 else 2 ** -7
    _close(got, np.asarray(want, np.float32), tol)
    init = layers.norm_init("layernorm", 24, "cpu", lead=(2,))
    assert set(init) == {"scale", "bias"}
    assert tuple(init["bias"].shape) == (2, 24)
    y = layers.apply_norm("layernorm", {k: torch.from_numpy(v)
                                        for k, v in p.items()},
                          torch.from_numpy(x.astype(np.float32)))
    _close(y, np.asarray(jlayers.apply_norm(
        "layernorm", {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x.astype(np.float32)))), NORM_TOL)


@pytest.mark.parametrize("length,d", [(1500, 512), (7, 64), (5, 6)])
def test_sinusoidal_positions_match_reference(length, d):
    got = layers.sinusoidal_positions(length, d, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlayers.sinusoidal_positions(length, d)))


def _attn_params(d, H, kv, hd, seed):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), d, H, kv, hd, jnp.float32)
    return jp, bridge.from_reference_params(jax.tree.map(np.asarray, jp),
                                            device="cpu")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,kv", [(24, 2), (attention.CHUNKED_THRESHOLD, 1)])
def test_attention_matches_reference(S, kv, causal):
    """Causal and bidirectional; at S = 4096 both sides take the chunked
    path (queries QUERY_CHUNK at a time), which gives ``_sdpa``'s values."""
    d, H, hd = 16, 2, 8
    jp, p = _attn_params(d, H, kv, hd, 3)
    x = _rand((1, S, d), 4)
    kw = dict(n_heads=H, n_kv=kv, head_dim=hd, rope_theta=10000.0,
              causal=causal)
    want = jattn.attention(jp, jnp.asarray(x), **kw)
    got = attention.attention(p, torch.from_numpy(x), **kw)
    _close(got, want)
    if S >= attention.CHUNKED_THRESHOLD:
        q, k, v = (torch.from_numpy(_rand((1, S, H, hd), s)) for s in (5, 6, 7))
        mask = attention.causal_mask(S, S, "cpu") if causal else None
        _close(attention._chunked_sdpa(q, k, v, causal=causal),
               attention._sdpa(q, k, v, mask).numpy(), 1e-6)


def test_noncausal_attention_sees_later_positions():
    """Bidirectional attention at position 0 depends on the last token;
    causal does not."""
    d, H, hd = 16, 2, 8
    _, p = _attn_params(d, H, 2, hd, 8)
    x = torch.from_numpy(_rand((1, 6, d), 9))
    x2 = x.clone()
    x2[0, -1] += 3.0
    kw = dict(n_heads=H, n_kv=2, head_dim=hd, rope_theta=0.0)
    for causal, moved in ((False, True), (True, False)):
        a = attention.attention(p, x, causal=causal, **kw)[0, 0]
        b = attention.attention(p, x2, causal=causal, **kw)[0, 0]
        assert bool((a - b).abs().max() > 1e-6) == moved


def test_cross_attention_matches_reference():
    d, H, hd = 16, 4, 8
    jp, p = _attn_params(d, H, 2, hd, 10)
    x, mem = _rand((2, 5, d), 11), _rand((2, 9, d), 12)
    kw = dict(n_heads=H, n_kv=2, head_dim=hd)
    _close(attention.cross_attention(p, torch.from_numpy(x),
                                     torch.from_numpy(mem), **kw),
           jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(mem), **kw))


# ---------------------------------------------------------------------------
# InternVL2's prefix embeddings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm():
    return _setup(VLM)


@pytest.mark.parametrize("use_flash", [True, False])
def test_prefix_forward_and_loss_match_reference(vlm, use_flash):
    jcfg, cfg, jparams, params = vlm
    P = cfg.frontend.num_prefix_tokens
    tokens, labels = _tokens(cfg, 2, 24, 1)
    pe = _rand((2, P, cfg.d_model), 2)
    jl, jaux = jtf.forward(jparams, jnp.asarray(tokens), jcfg,
                           prefix_embeds=jnp.asarray(pe), use_flash=use_flash)
    jloss, jm = japi.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels),
                                       "prefix_embeds": jnp.asarray(pe)},
                             jcfg, use_flash=use_flash)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "prefix_embeds": torch.from_numpy(pe)}
    with torch.no_grad():
        logits, aux = transformer.forward(
            params, batch["tokens"], cfg, prefix_embeds=batch["prefix_embeds"],
            use_flash=use_flash)
        loss, m = api.loss_fn(params, batch, cfg, use_flash=use_flash)
        # the prefix positions are not scored: the loss is the text
        # positions' cross-entropy of the same forward
        h, _ = transformer.forward(params, batch["tokens"], cfg,
                                   prefix_embeds=batch["prefix_embeds"],
                                   return_hidden=True, use_flash=use_flash)
        ce = api.fused_xent(h[:, P:], transformer.head_matrix(params),
                            batch["labels"])
    assert tuple(logits.shape) == (2, P + 24, cfg.vocab_size)
    _close(logits, jl)
    _close(loss, jloss)
    _close(m["ce"], jm["ce"])
    assert float(aux) == float(jaux) == 0.0
    assert torch.equal(ce, m["ce"])


def test_prefix_prefill_and_decode_match_reference(vlm):
    """``prefill_fn`` with the prefix, then ``decode_fn`` steps at
    positions P + S, ...: logits and caches against the reference's, and
    the steps' logits against the teacher-forced forward of the longer
    sequence."""
    jcfg, cfg, jparams, params = vlm
    P = cfg.frontend.num_prefix_tokens
    tokens, _ = _tokens(cfg, 2, 10, 3)
    nxt, _ = _tokens(cfg, 2, 3, 4)
    pe = _rand((2, P, cfg.d_model), 5)
    max_seq = P + 16
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(tokens),
                                       "prefix_embeds": jnp.asarray(pe)},
                             jcfg, max_seq)
    with torch.no_grad():
        logits, caches = api.prefill_fn(
            params, {"tokens": torch.from_numpy(tokens),
                     "prefix_embeds": torch.from_numpy(pe)}, cfg, max_seq)
        _close(logits, jl)
        _close(caches[0].kv.k, jc[0].kv.k)
        _close(caches[0].kv.v, jc[0].kv.v)
        steps = []
        for i in range(nxt.shape[1]):
            pos = P + tokens.shape[1] + i
            lg, caches = api.decode_fn(params, torch.from_numpy(nxt[:, i:i + 1]),
                                       caches, torch.full((2,), pos), cfg)
            jlg, jc = japi.decode_fn(jparams, jnp.asarray(nxt[:, i:i + 1]), jc,
                                     jnp.full((2,), pos, jnp.int32), jcfg)
            _close(lg, jlg)
            steps.append(lg)
        _close(caches[0].kv.k, jc[0].kv.k)
        full, _ = transformer.forward(
            params, torch.from_numpy(np.concatenate([tokens, nxt], 1)), cfg,
            prefix_embeds=torch.from_numpy(pe))
    _close(torch.cat(steps, 1), bridge.to_numpy(full[:, -nxt.shape[1]:]))


# ---------------------------------------------------------------------------
# the non-paged decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", QWEN])
def test_decode_step_matches_reference(arch):
    """From ``init_caches`` (each row at its own length) and after a
    ``prefill``: four ``decode_step`` / ``decode_fn`` steps under
    ``capacity``, logits and caches against the reference's; under
    ``dense`` the prefill + steps give the teacher-forced forward's
    logits."""
    jcfg, cfg, jparams, params = _setup(arch, seed=2)
    B, S, n = 2, 6, 4
    tokens, _ = _tokens(cfg, B, S + n, 6)
    with torch.no_grad():
        caches = transformer.init_caches(cfg, B, 16, device="cpu")
        jc = jtf.init_caches(jcfg, B, 16)
        assert [tuple(t.shape) for t in caches[0].kv] == \
            [t.shape for t in jc[0].kv]
        lens = np.array([0, 3])
        lg, caches = transformer.decode_step(
            params, torch.from_numpy(tokens[:, :1]), caches,
            torch.from_numpy(lens), cfg, spec=CAPACITY)
        jlg, jc = jtf.decode_step(jparams, jnp.asarray(tokens[:, :1]), jc,
                                  jnp.asarray(lens), jcfg, spec=CAPACITY)
        _close(lg, jlg)
        _close(caches[0].kv.k, jc[0].kv.k)
        logits, caches = api.prefill_fn(
            params, {"tokens": torch.from_numpy(tokens[:, :S])}, cfg, 16,
            spec=CAPACITY)
        jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(tokens[:, :S])},
                                 jcfg, 16, spec=CAPACITY)
        _close(logits, jl)
        steps = [logits[:, -1:]]
        for i in range(S, S + n - 1):
            tok = tokens[:, i:i + 1]
            lg, caches = api.decode_fn(params, torch.from_numpy(tok), caches,
                                       torch.full((B,), i), cfg, spec=CAPACITY)
            jlg, jc = japi.decode_fn(jparams, jnp.asarray(tok), jc,
                                     jnp.full((B,), i, jnp.int32), jcfg,
                                     spec=CAPACITY)
            _close(lg, jlg)
            steps.append(lg)
        for s in range(len(caches)):
            _close(caches[s].kv.k, jc[s].kv.k)
            _close(caches[s].kv.v, jc[s].kv.v)
        # capacity drops tokens of the longer forward that a step keeps, so
        # decode == teacher forcing is held under ``dense``
        logits, caches = transformer.prefill(
            params, torch.from_numpy(tokens[:, :S]), cfg, 16, spec="dense")
        steps = [logits[:, -1:]]
        for i in range(S, S + n - 1):
            lg, caches = transformer.decode_step(
                params, torch.from_numpy(tokens[:, i:i + 1]), caches,
                torch.full((B,), i), cfg, spec="dense")
            steps.append(lg)
        full, _ = transformer.forward(params, torch.from_numpy(tokens), cfg,
                                      spec="dense")
    _close(torch.cat(steps, 1), bridge.to_numpy(full[:, S - 1:S + n - 1]))


def test_init_decode_caches_shapes():
    _, cfg, jparams, params = _setup(QWEN)
    caches = api.init_decode_caches(params, cfg, 3, 12)
    jc = japi.init_decode_caches(jparams, jreduced(QWEN).replace(
        dtype="float32"), 3, 12)
    assert len(caches) == len(jc)
    for c, j in zip(caches, jc):
        assert tuple(c.kv.k.shape) == j.kv.k.shape
        assert c.kv.k.dtype == torch.float32 and not c.kv.k.any()


# ---------------------------------------------------------------------------
# the other new LM families, DeepSeek's shared experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [DEEPSEEK, QWEN, "yuan2-m32",
                                  "phi3.5-moe-42b-a6.6b", "nemotron-4-15b",
                                  "nemotron-4-340b", "stablelm-1.6b",
                                  "yi-6b", NEMOTRON_HD192])
def test_family_forward_and_loss_match_reference(arch):
    """The scoring forward under ``capacity`` (the reduced MoE configs
    name ``dense``, the full ones ``fse_dp``): logits, the aux loss and the
    loss at 1e-4; NEMOTRON_HD192 through flash at hd 192 (the Pallas
    kernel in interpret mode, the port's plain version)."""
    jcfg, cfg, jparams, params = _setup(arch)
    tokens, labels = _tokens(cfg, 2, 16, 7)
    spec = CAPACITY if cfg.moe else None
    flash = arch == NEMOTRON_HD192
    jl, jaux = jtf.forward(jparams, jnp.asarray(tokens), jcfg, spec=spec,
                           use_flash=flash)
    jloss, _ = japi.loss_fn(jparams, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)},
                            jcfg, spec=spec, use_flash=flash)
    with torch.no_grad():
        logits, aux = transformer.forward(params, torch.from_numpy(tokens),
                                          cfg, spec=spec, use_flash=flash)
        loss, _ = api.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)},
                              cfg, spec=spec, use_flash=flash)
    _close(logits, jl)
    _close(aux, jaux)
    _close(loss, jloss)


@pytest.mark.parametrize("spec", ["dense", "capacity"])
def test_shared_expert_moe_block_matches_reference(spec):
    """The full DeepSeek MoE config's block at small widths (E = 64, top-6,
    two shared experts a layer: 2 x d_expert of always-on FFN)."""
    jmcfg = dataclasses.replace(jget(DEEPSEEK).moe, d_expert=16)
    mcfg = dataclasses.replace(get_config(DEEPSEEK).moe, d_expert=16)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), 32, jmcfg, "swiglu",
                       jnp.float32)
    p = bridge.from_reference_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    assert tuple(p["shared"]["w_up"].shape) == (32, 32)
    x = _rand((2, 12, 32), 8)
    with jops.use_kernels(False):
        want = jmoe.moe_block(jp, jnp.asarray(x), jmcfg, "swiglu", spec=spec)
    with torch.no_grad():
        got = moe.moe_block(p, torch.from_numpy(x), mcfg, "swiglu", spec=spec)
        bare = moe.moe_block({k: v for k, v in p.items() if k != "shared"},
                             torch.from_numpy(x),
                             dataclasses.replace(mcfg, num_shared_experts=0),
                             "swiglu", spec=spec)
    _close(got, want, MOE_TOL)
    assert (got - bare).abs().max() > 1e-3       # the shared experts ran


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

PROMPTS = ([5, 9, 2, 77, 31], [100, 3, 64], [7, 7, 8, 1, 2, 3, 4], [60, 61])
STATS = ("tokens_emitted", "iterations", "deferrals", "expert_loads",
         "expert_loads_saved", "dynamic_schedules", "host_syncs",
         "prefill_chunks", "prefill_tokens", "resident_state_bytes",
         "peak_resident_state_bytes", "resident_weight_bytes",
         "ddr_bytes_saved", "hybrid_repartitions")
# (arch, admission) -> spec; Qwen3's chunked run under the dynamic schedule
ENGINE_CASES = {
    (DEEPSEEK, "submit"): CAPACITY,
    (DEEPSEEK, "chunked"): CAPACITY,
    (QWEN, "submit"): CAPACITY,
    (QWEN, "chunked"): {"strategy": "capacity", "schedule": "dynamic"},
    (NEMOTRON, "submit"): CAPACITY,
}
# a dense model's slice: 2 requests x 8 -> 8 tokens (chip_smoke.py phase
# nemotron serves 4 x 8 -> 16 of the full-width model)
ENGINE_PROMPTS = {NEMOTRON: (([3, 14, 15, 92, 65, 35, 89, 79],
                              [32, 38, 46, 26, 43, 38, 32, 79]), 8)}


@pytest.fixture(scope="module")
def engine_models():
    return {arch: _setup(arch, seed=1) for arch in (DEEPSEEK, QWEN, NEMOTRON)}


def _kw(spec):
    return dict(max_batch=4, max_ctx=32, theta_min=2, page_size=4,
                chunk_tokens=3, spec=dict(spec))


def _serve(engine, chunked, arch):
    prompts, max_new = ENGINE_PROMPTS.get(arch, (PROMPTS, 6))
    sub = engine.submit_chunked if chunked else engine.submit
    rids = [sub(list(p), max_new=max_new) for p in prompts]
    outs = engine.run()
    return [outs[r] for r in rids]


@pytest.fixture(scope="module")
def engine_reference(engine_models):
    out = {}
    with jops.use_kernels(False):
        for (arch, adm), spec in ENGINE_CASES.items():
            jcfg, _, jparams, _ = engine_models[arch]
            jeng = JEngine(jparams, jcfg, JServeConfig(**_kw(spec)))
            out[arch, adm] = (jeng, _serve(jeng, adm == "chunked", arch))
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES),
                         ids=["-".join(c) for c in ENGINE_CASES])
def test_engine_matches_reference(engine_models, engine_reference, case):
    arch, adm = case
    _, cfg, _, params = engine_models[arch]
    jeng, want = engine_reference[case]
    for fused in (True, False):
        eng = Engine(params, cfg, ServeConfig(fused=fused,
                                              **_kw(ENGINE_CASES[case])),
                     device="cpu")
        assert _serve(eng, adm == "chunked", arch) == want
        assert len(eng.trace) == len(jeng.trace)
        assert (len(eng.trace) > 0) == (cfg.moe is not None)  # MoE records
        for rec, jrec in zip(eng.trace, jeng.trace):
            assert set(rec) == set(jrec)
            assert "modeled_s" in rec or rec.get("event")
            for k in rec:
                if k == "counts":
                    np.testing.assert_array_equal(rec[k], jrec[k])
                else:
                    assert rec[k] == jrec[k], k
        stats = STATS if fused else [k for k in STATS if k != "host_syncs"]
        assert {k: eng.stats[k] for k in stats} == \
            {k: jeng.stats[k] for k in stats}
        assert eng.last_step_modeled_s == jeng.last_step_modeled_s
        if fused:
            nb = len(eng.megastep().boundaries)
            assert nb == cfg.ffn_kinds().count("moe")
            if adm == "submit":  # a sync a MoE boundary, one a logits fetch
                assert eng.stats["host_syncs"] == \
                    eng.stats["iterations"] * (nb + 1)


@pytest.mark.parametrize("arch", [DEEPSEEK, QWEN, "yuan2-m32",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_cli_dry_run_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--dry-run"])
    assert "dry-run OK" in capsys.readouterr().out

"""Serving the SSM and hybrid families: port vs JAX on the CPU.

* ``mamba2_prefill`` (plain and through the SSD kernel's plain version),
  ``mamba2_chunk`` (with a row's valid prefix), ``mamba2_decode`` and
  ``ssd_decode_step`` against the reference on the same inputs and weights
  at 2e-5 (the reference's kernel-path tolerance: the same algorithm, sums
  in other orders); chunked == one-shot prefill at the reference's 2e-4
  (``tests/test_chunked_prefill.py``), decode after a prefill == the
  prefill of the longer sequence at its 2e-3 (``tests/test_mamba2.py``); a
  masked tail equals the shorter chunk and an all-False row leaves a
  nonzero state bit for bit;
* the state pool's SSM rows (``snapshot_ssm``, ``restore_ssm``,
  ``zero_ssm``, ``merge_prefill``, ``state_bytes``, the held-row
  accounting) against the reference, and snapshot -> restore bit-exact and
  in place;
* ``transformer.prefill`` / ``prefill_chunk`` / ``decode_mixer`` on reduced
  Jamba: logits and states at 2e-5 against the reference's, masked rows
  untouched, the state tensors written in place (the fused segments'
  graphs replay fixed addresses);
* the engine on reduced Jamba and reduced mamba2-370m in fp32, ``submit``
  and ``submit_chunked``, fused and eager, static and dynamic (and
  deferral, and ``hybrid`` with the resident tier on Jamba): tokens, the
  trace with ``modeled_s`` and the statistics equal to the reference
  engine's (run once per module, ``use_kernels(False)``);
* snapshot -> evict -> intruder -> restore is bit-exact on the SSM rows
  and the restored request emits the never-preempted run's tokens (the
  reference's ``test_mamba_snapshot_evict_restore_exact``); a prefix-cache
  hit restores the snapshot and gives the uncached run's tokens;
* the bridge copies the reduced Jamba and mamba2 trees leaf for leaf; the
  serve CLI runs both archs on ``--device cpu``; the simulator's spec of
  Jamba equals the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.configs.base import SSMConfig as JSSMConfig
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import mamba2 as jm2
from repro.models import transformer as jtf
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving import statepool as jstatepool
from repro.sim import hardware as jhw
from repro_torch import bridge, tree
from repro_torch.configs import SSMConfig, reduced_config
from repro_torch.kernels import ssd
from repro_torch.launch import serve
from repro_torch.models import mamba2, transformer
from repro_torch.serving import Engine, ServeConfig, statepool
from repro_torch.sim import hardware

JAMBA, MAMBA = "jamba-v0.1-52b", "mamba2-370m"
SAME_TOL = 2e-5        # one algorithm, fp32 sums in other orders
CHUNKED_TOL = 2e-4     # chunked (sequential) vs one-shot (chunked SSD)
DECODE_TOL = 2e-3      # decode steps vs the prefill of the longer sequence
PROMPTS = ([5, 9, 2, 77, 31], [100, 3, 64], [7, 7, 8, 1, 2, 3, 4], [60, 61])
STATS = ("tokens_emitted", "iterations", "deferrals", "expert_loads",
         "expert_loads_saved", "dynamic_schedules", "host_syncs",
         "prefill_chunks", "prefill_tokens", "resident_state_bytes",
         "peak_resident_state_bytes", "resident_weight_bytes",
         "ddr_bytes_saved", "hybrid_repartitions")
# (arch, spec, slack, resident MiB), each run fused and eager; static and
# dynamic with both admissions, deferral and hybrid + the resident tier
# (two of reduced Jamba's experts a layer) chunked only, to bound the
# reference's one-shot prefills
CAPACITY = {"strategy": "capacity"}
DYNAMIC = {"strategy": "capacity", "schedule": "dynamic"}
ENGINE_CASES = {
    ("jamba-static", "submit"): (JAMBA, CAPACITY, 0.0, 0.0),
    ("jamba-static", "chunked"): (JAMBA, CAPACITY, 0.0, 0.0),
    ("jamba-dynamic", "submit"): (JAMBA, DYNAMIC, 0.0, 0.0),
    ("jamba-dynamic", "chunked"): (JAMBA, DYNAMIC, 0.0, 0.0),
    ("jamba-slack", "chunked"): (JAMBA, CAPACITY, 0.2, 0.0),
    ("jamba-hybrid", "chunked"): (JAMBA, {"strategy": "hybrid",
                                          "schedule": "dynamic"}, 0.0, 0.4),
    ("mamba-static", "submit"): (MAMBA, CAPACITY, 0.0, 0.0),
    ("mamba-static", "chunked"): (MAMBA, CAPACITY, 0.0, 0.0),
    ("mamba-dynamic", "submit"): (MAMBA, DYNAMIC, 0.0, 0.0),
    ("mamba-dynamic", "chunked"): (MAMBA, DYNAMIC, 0.0, 0.0),
}


def _close(got, want, tol):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the Mamba-2 serving entry points
# ---------------------------------------------------------------------------

D_MODEL = 16


def _ssm(groups):
    kw = dict(d_state=16, d_conv=4, expand=2, head_dim=8, n_groups=groups)
    return JSSMConfig(**kw), SSMConfig(**kw)


def _block(seed, groups=1):
    jssm, ssm = _ssm(groups)
    jp = jm2.mamba2_init(jax.random.PRNGKey(seed), D_MODEL, jssm, jnp.float32)
    return jssm, ssm, jp, bridge.from_reference_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _state(st):
    return mamba2.SSMState(*(bridge.to_tensor(np.asarray(a), "cpu")
                             for a in st))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("L", [8, 10, 64])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_prefill_matches_reference(use_kernel, L, groups):
    """L = 10 runs chunk 10, L = 64 chunk 64 (chunk_size 256), both one
    chunk; the reference has no kernel switch here."""
    jssm, ssm, jp, p = _block(5, groups)
    x = _x((2, L, D_MODEL), L)
    jy, jst = jm2.mamba2_prefill(jp, jnp.asarray(x), jssm, D_MODEL)
    before = ssd.LAUNCHES
    with torch.no_grad():
        y, st = mamba2.mamba2_prefill(p, torch.from_numpy(x), ssm, D_MODEL,
                                      use_kernel=use_kernel)
    assert ssd.LAUNCHES == before           # CPU tensors: the plain version
    _close(y, jy, SAME_TOL)
    _close(st.conv, jst.conv, SAME_TOL)
    _close(st.ssd, jst.ssd, SAME_TOL)
    assert st.ssd.dtype == torch.float32


def test_mamba2_prefill_short_prompt_pads_window():
    """A prompt shorter than the conv window (L = 2 < d_conv - 1) pads the
    window with zeros in front, as the reference."""
    jssm, ssm, jp, p = _block(6)
    x = _x((1, 2, D_MODEL), 1)
    jy, jst = jm2.mamba2_prefill(jp, jnp.asarray(x), jssm, D_MODEL)
    with torch.no_grad():
        y, st = mamba2.mamba2_prefill(p, torch.from_numpy(x), ssm, D_MODEL)
    _close(y, jy, SAME_TOL)
    np.testing.assert_array_equal(bridge.to_numpy(st.conv),
                                  np.asarray(jst.conv))


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_chunk_matches_reference(groups):
    """Chunk by chunk with each row's valid prefix, from the same states:
    y (valid positions) and the new state against the reference's."""
    jssm, ssm, jp, p = _block(7, groups)
    B = 3
    js = jm2.init_ssm_state(B, D_MODEL, jssm, jnp.float32)
    st = mamba2.init_ssm_state(B, D_MODEL, ssm, torch.float32, "cpu")
    masks = (np.array([[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]], bool),
             np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool),
             np.ones((B, 4), bool))
    for i, m in enumerate(masks):
        x = _x((B, 4, D_MODEL), 20 + i)
        jy, js = jm2.mamba2_chunk(jp, jnp.asarray(x), js, jssm, D_MODEL,
                                  token_mask=jnp.asarray(m))
        with torch.no_grad():
            y, st = mamba2.mamba2_chunk(p, torch.from_numpy(x), st, ssm,
                                        D_MODEL,
                                        token_mask=torch.from_numpy(m))
        _close(torch.where(torch.from_numpy(m)[..., None], y, 0),
               np.where(m[..., None], np.asarray(jy), 0), SAME_TOL)
        _close(st.conv, js.conv, SAME_TOL)
        _close(st.ssd, js.ssd, SAME_TOL)


def test_mamba2_chunked_equals_prefill():
    """Chunks of 3, 4 and 3 tokens from the zero state give the one-shot
    prefill's outputs and final state (the reference's own check)."""
    _, ssm, _, p = _block(5)
    x = torch.from_numpy(_x((2, 10, D_MODEL), 6))
    with torch.no_grad():
        full, fst = mamba2.mamba2_prefill(p, x, ssm, D_MODEL)
        st = mamba2.init_ssm_state(2, D_MODEL, ssm, torch.float32, "cpu")
        outs = []
        for k0, k1 in ((0, 3), (3, 7), (7, 10)):
            y, st = mamba2.mamba2_chunk(p, x[:, k0:k1], st, ssm, D_MODEL)
            outs.append(y)
    _close(torch.cat(outs, 1), bridge.to_numpy(full), CHUNKED_TOL)
    _close(st.conv, bridge.to_numpy(fst.conv), 1e-5)
    _close(st.ssd, bridge.to_numpy(fst.ssd), CHUNKED_TOL)


def test_mamba2_chunk_masked_tail_is_noop():
    """4 valid tokens and 2 masked ones == the 4-token chunk; an all-False
    row leaves a nonzero state bit for bit (conv window and SSD state)."""
    _, ssm, _, p = _block(7)
    x = torch.from_numpy(_x((2, 6, D_MODEL), 8))
    with torch.no_grad():
        st0 = mamba2.init_ssm_state(2, D_MODEL, ssm, torch.float32, "cpu")
        _, st0 = mamba2.mamba2_chunk(p, torch.from_numpy(
            _x((2, 5, D_MODEL), 9)), st0, ssm, D_MODEL)
        mask = torch.tensor([[True] * 4 + [False] * 2] * 2)
        _, s_mask = mamba2.mamba2_chunk(p, x, st0, ssm, D_MODEL,
                                        token_mask=mask)
        _, s_exact = mamba2.mamba2_chunk(p, x[:, :4], st0, ssm, D_MODEL)
        _close(s_mask.conv, bridge.to_numpy(s_exact.conv), 1e-6)
        _close(s_mask.ssd, bridge.to_numpy(s_exact.ssd), 1e-6)
        _, s_noop = mamba2.mamba2_chunk(p, x, st0, ssm, D_MODEL,
                                        token_mask=torch.zeros((2, 6),
                                                               dtype=bool))
    assert st0.ssd.abs().sum() > 0 and st0.conv.abs().sum() > 0
    assert torch.equal(s_noop.conv, st0.conv)
    assert torch.equal(s_noop.ssd, st0.ssd)


def test_mamba2_decode_matches_reference():
    """Four decode steps from a prefill state against the reference's, then
    against the port's own prefill of the whole sequence."""
    jssm, ssm, jp, p = _block(3)
    x = _x((2, 12, D_MODEL), 4)
    _, js = jm2.mamba2_prefill(jp, jnp.asarray(x[:, :8]), jssm, D_MODEL)
    st = _state(js)
    with torch.no_grad():
        full, _ = mamba2.mamba2_prefill(p, torch.from_numpy(x), ssm, D_MODEL)
        for t in range(8, 12):
            jy, js = jm2.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), js,
                                       jssm, D_MODEL)
            y, st = mamba2.mamba2_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                         st, ssm, D_MODEL)
            assert tuple(y.shape) == (2, 1, D_MODEL)
            _close(y, jy, SAME_TOL)
            _close(st.conv, js.conv, SAME_TOL)
            _close(st.ssd, js.ssd, SAME_TOL)
            _close(y, bridge.to_numpy(full[:, t:t + 1]), DECODE_TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(2)
    b, h, p_, n = 2, 4, 8, 16
    args = (rng.standard_normal((b, h, p_, n)), rng.standard_normal((b, h, p_)),
            np.log1p(np.exp(rng.standard_normal((b, h)))),
            -np.abs(rng.standard_normal(h)), rng.standard_normal((b, h, n)),
            rng.standard_normal((b, h, n)))
    args = [a.astype(np.float32) for a in args]
    js, jy = jm2.ssd_decode_step(*(jnp.asarray(a) for a in args))
    s, y = mamba2.ssd_decode_step(*(torch.from_numpy(a) for a in args))
    _close(s, js, SAME_TOL)
    _close(y, jy, SAME_TOL)


def test_ssm_state_rows_exact_and_in_place():
    """A snapshot is a copy; restore and zero write in place, touch only
    their row and give back the snapshot's bits."""
    _, ssm, _, _ = _block(0)
    st = mamba2.init_ssm_state(3, D_MODEL, ssm, torch.float32, "cpu",
                               lead=(2,))
    for a in st:
        a.copy_(torch.from_numpy(_x(tuple(a.shape), a.dim())))
    ptrs = [a.data_ptr() for a in st]
    before = [a.clone() for a in st]
    snap = mamba2.ssm_state_slice(st, 1)
    assert all(s.data_ptr() != a.data_ptr() for s, a in zip(snap, st))
    mamba2.ssm_state_zero_row(st, 1)
    assert all(not a[:, 1].any() for a in st)
    for a, b in zip(st, before):
        assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])
    mamba2.ssm_state_restore(st, snap, 1)
    assert all(torch.equal(a, b) for a, b in zip(st, before))
    assert [a.data_ptr() for a in st] == ptrs


# ---------------------------------------------------------------------------
# reduced Jamba: weights, the model's serving entry points, the pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in (JAMBA, MAMBA):
        jcfg = jreduced(arch).replace(dtype="float32")
        cfg = reduced_config(arch).replace(dtype="float32")
        jparams = japi.init_params(jax.random.PRNGKey(1), jcfg)
        params = bridge.from_reference_params(
            jax.tree.map(np.asarray, jparams), device="cpu")
        out[arch] = (jcfg, cfg, jparams, params)
    return out


@pytest.mark.parametrize("arch", [JAMBA, MAMBA])
def test_bridge_copies_ssm_trees_leaf_for_leaf(models, arch):
    """Each slot of the period (Jamba's 8: 1 attention and 7 Mamba-2
    layers, MoE on every other) holds the reference's leaves, bit for
    bit, stacked over periods as the reference stacks them."""
    jcfg, cfg, jparams, params = models[arch]
    p, plan = transformer.period_plan(cfg)
    assert (p, plan) == jtf.period_plan(jcfg)
    if arch == JAMBA:
        assert p == 8 and [m for m, _ in plan].count("attn") == 1
        assert [f for _, f in plan].count("moe") == 4
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    n = 0
    for path, leaf in leaves:
        node = params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(bridge.to_numpy(node),
                                      np.asarray(leaf, np.float32))
        n += 1
    assert n == len(tree.leaves(params))
    for s, (mixer, _) in enumerate(plan):
        assert ("ssm" in params["periods"][s]) == (mixer == "ssm")


def _jamba_caches(models, B, NP, ps, seed):
    """The same random pool on both sides (the port's sink page aside)."""
    jcfg, cfg, _, _ = models[JAMBA]
    jc = jtf.init_paged_caches(jcfg, B, B * NP, ps)
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jc)
    tc = transformer.init_paged_caches(cfg, B, B * NP, ps, device="cpu")
    for c, j in zip(tc, jc):
        for a, ja in zip(c.kv, j.kv):
            a[:, :-1] = bridge.to_tensor(np.asarray(ja), "cpu")
        for a, ja in zip(c.ssm, j.ssm):
            a.copy_(bridge.to_tensor(np.asarray(ja), "cpu"))
    return jc, tc


def test_jamba_prefill_matches_reference(models):
    jcfg, cfg, jparams, params = models[JAMBA]
    tokens = np.array([[3, 17, 90, 5, 64, 2, 8]])
    jl, jc = jtf.prefill(jparams, jnp.asarray(tokens), jcfg, 16,
                         spec="capacity")
    with torch.no_grad():
        logits, caches = transformer.prefill(params, torch.from_numpy(tokens),
                                             cfg, 16, spec="capacity")
    _close(logits, jl, SAME_TOL)
    for c, j in zip(caches, jc):
        for a, ja in zip(c.kv, j.kv):
            _close(a, ja, SAME_TOL)
        for a, ja in zip(c.ssm, j.ssm):
            _close(a, ja, SAME_TOL)
        assert (c.kv == ()) == (j.kv == ())


def test_jamba_prefill_chunk_matches_reference(models):
    """A paged chunk step on a random pool: the hidden states of the valid
    positions, the counts and every SSM row at 2e-5; the all-False row's
    SSM state keeps its bits; the SSM stacks are written in place."""
    jcfg, cfg, jparams, params = models[JAMBA]
    B, NP, ps, K = 3, 4, 4, 5
    jc, tc = _jamba_caches(models, B, NP, ps, seed=0)
    table = np.arange(B * NP, dtype=np.int64).reshape(B, NP)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, K))
    mask = np.array([[1] * 5, [1, 1, 0, 0, 0], [0] * 5], bool)
    cl = np.array([3, 6, 2])
    jh, jnew, jcnt = jtf.prefill_chunk(
        jparams, jnp.asarray(tokens, jnp.int32), jc, jnp.asarray(cl, jnp.int32),
        jcfg, spec="capacity", token_mask=jnp.asarray(mask),
        return_hidden=True, page_table=jnp.asarray(table, jnp.int32))
    idle = [tuple(a[:, 2].clone() for a in c.ssm) for c in tc]
    ptrs = [[a.data_ptr() for a in c.ssm] for c in tc]
    with torch.no_grad():
        th, tnew, tcnt = transformer.prefill_chunk(
            params, torch.from_numpy(tokens), tc, torch.from_numpy(cl), cfg,
            spec="capacity", token_mask=torch.from_numpy(mask),
            return_hidden=True, page_table=torch.from_numpy(table))
    assert tnew is tc
    _close(torch.where(torch.from_numpy(mask)[..., None], th, 0),
           np.where(mask[..., None], np.asarray(jh), 0), SAME_TOL)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    for c, j, keep, ptr in zip(tc, jnew, idle, ptrs):
        for a, ja in zip(c.ssm, j.ssm):
            _close(a, ja, SAME_TOL)
        assert all(torch.equal(a[:, 2], k) for a, k in zip(c.ssm, keep))
        assert [a.data_ptr() for a in c.ssm] == ptr


def test_jamba_decode_mixer_masked_and_in_place(models):
    """One masked SSM decode step: the masked rows' state and residual as
    the reference's, the others' bit for bit as before, in place."""
    jcfg, cfg, jparams, params = models[JAMBA]
    B, NP, ps = 3, 4, 4
    jc, tc = _jamba_caches(models, B, NP, ps, seed=2)
    x = _x((B, 1, cfg.d_model), 3)
    mask = np.array([True, False, True])
    cl = np.array([3, 5, 7])
    table = np.arange(B * NP, dtype=np.int64).reshape(B, NP)
    layer = 0                                    # an SSM slot
    assert transformer.period_plan(cfg)[1][layer][0] == "ssm"
    jx, jnew = jtf.decode_mixer(jparams, jnp.asarray(x), jc,
                                jnp.asarray(cl, jnp.int32), jcfg, layer,
                                jnp.asarray(mask),
                                page_table=jnp.asarray(table, jnp.int32))
    before = [a.clone() for a in tc[layer].ssm]
    ptrs = [a.data_ptr() for a in tc[layer].ssm]
    with torch.no_grad():
        tx, tnew = transformer.decode_mixer(
            params, torch.from_numpy(x), tc, torch.from_numpy(cl), cfg, layer,
            torch.from_numpy(mask), page_table=torch.from_numpy(table))
    _close(tx, jx, SAME_TOL)
    assert torch.equal(tx[1], torch.from_numpy(x)[1])
    for a, ja, b in zip(tnew[layer].ssm, jnew[layer].ssm, before):
        _close(a, ja, SAME_TOL)
        assert torch.equal(a[:, 1], b[:, 1])
    assert [a.data_ptr() for a in tnew[layer].ssm] == ptrs


def test_ssm_pool_helpers_match_reference(models):
    """snapshot / restore / zero / merge_prefill's SSM rows / state_bytes
    on reduced Jamba's caches against the reference's."""
    jcfg, cfg, jparams, params = models[JAMBA]
    jc, tc = _jamba_caches(models, 3, 4, 4, seed=4)
    assert statepool.has_ssm(tc) and jstatepool.has_ssm(jc)
    assert statepool.state_bytes(tc)[1] == jstatepool.state_bytes(jc)[1] > 0
    snap, jsnap = statepool.snapshot_ssm(tc, 1), jstatepool.snapshot_ssm(jc, 1)
    assert len(snap) == len(jsnap)
    for s, js in zip(snap, jsnap):
        assert (s == ()) == (js == ())
        for a, ja in zip(s, js):
            np.testing.assert_array_equal(bridge.to_numpy(a), np.asarray(ja))
    statepool.zero_ssm(tc, 1)
    jc = jstatepool.zero_ssm(jc, 1)
    statepool.restore_ssm(tc, snap, 2)
    jc = jstatepool.restore_ssm(jc, jsnap, 2)
    tokens = np.array([[4, 8, 15, 16, 23, 42]])
    _, jc1 = jtf.prefill(jparams, jnp.asarray(tokens), jcfg, 16,
                         spec="capacity")
    with torch.no_grad():
        _, tc1 = transformer.prefill(params, torch.from_numpy(tokens), cfg,
                                     16, spec="capacity")
    jc = jstatepool.merge_prefill(jc, jc1, [5, 6], 0, 4)
    statepool.merge_prefill(tc, tc1, [5, 6], 0, 4)
    for c, j in zip(tc, jc):
        for a, ja in zip(c.ssm, j.ssm):
            _close(a, ja, SAME_TOL)
            np.testing.assert_array_equal(bridge.to_numpy(a[:, 1:]),
                                          np.asarray(ja)[:, 1:])
        for a, ja in zip(c.kv, j.kv):
            _close(a[:, :-1], ja, SAME_TOL)


def _pool_log(mod, ssm_row):
    """One sequence of pool calls with SSM snapshots held by entries and
    handles; the held rows and the resident bytes after each."""
    pool = mod.StatePool(max_batch=2, max_ctx=16, page_size=4, num_pages=10,
                         max_prefix_entries=2, bytes_per_page=100,
                         ssm_bytes_per_row=1000)
    keys = mod.hash_chain(list(range(1, 17)))
    log = []

    def note(name):
        log.append((name, pool._ssm_rows_held,
                    pool.stats["resident_state_bytes"],
                    pool.stats["peak_resident_state_bytes"]))

    pool.ensure(0, 8)
    note("ensure")
    for L in (4, 6, 8):                   # the third evicts the first (LRU)
        pool.register_prefix(keys[L - 1], L, 0, ssm=ssm_row)
        note(f"register {L}")
    pool.register_prefix(keys[7], 8, 0, ssm=ssm_row)     # cached: no-op
    note("register again")
    handle = mod.PreemptedState(request=None, page_ids=pool.detach_slot(
        0, has_ssm=ssm_row != ()), cache_len=8, ssm=ssm_row)
    note("detach")
    pool.attach_pages(1, handle.page_ids, has_ssm=ssm_row != ())
    note("attach")
    handle = mod.PreemptedState(request=None, page_ids=pool.detach_slot(
        1, has_ssm=ssm_row != ()), cache_len=8, ssm=ssm_row)
    pool.drop_handle(handle)
    note("drop")
    while pool.entries:
        pool._evict_lru()
    note("evicted")
    return log


@pytest.mark.parametrize("has_ssm", [True, False], ids=["ssm", "attention"])
def test_ssm_row_accounting_matches_reference(has_ssm):
    row = ("snapshot",) if has_ssm else ()
    got, want = _pool_log(statepool, row), _pool_log(jstatepool, row)
    assert got == want
    if has_ssm:
        assert max(h for _, h, _, _ in got) == 3     # 2 entries, 1 handle
    else:
        assert all(h == 0 for _, h, _, _ in got)
    assert got[-1][1] == 0


def test_detach_attach_ssm_accounting_pure_attention():
    """A pure-attention preemption holds no SSM row and adds no bytes; a
    hybrid one holds one; ``drop_handle`` releases only what a handle
    holds (the reference's regression test)."""
    pool = statepool.StatePool(max_batch=2, max_ctx=16, page_size=4,
                               bytes_per_page=100, ssm_bytes_per_row=1000)
    pool.ensure(0, 8)
    base = pool.stats["resident_state_bytes"]
    assert base == 200
    held = pool.detach_slot(0, has_ssm=False)
    assert pool._ssm_rows_held == 0
    assert pool.stats["resident_state_bytes"] == base
    pool.attach_pages(0, held, has_ssm=False)
    assert pool._ssm_rows_held == 0
    assert pool.stats["resident_state_bytes"] == base
    held = pool.detach_slot(0, has_ssm=True)
    assert pool._ssm_rows_held == 1
    assert pool.stats["resident_state_bytes"] == base + 1000
    pool.attach_pages(0, held, has_ssm=True)
    assert pool._ssm_rows_held == 0
    assert pool.stats["resident_state_bytes"] == base
    pool.drop_handle(statepool.PreemptedState(request=None, page_ids=[],
                                              cache_len=0, ssm=()))
    assert pool._ssm_rows_held == 0


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------


def _kw(spec, slack, resident):
    return dict(max_batch=4, max_ctx=32, buffering_slack=slack, theta_min=2,
                page_size=4, chunk_tokens=3, spec=dict(spec),
                resident_budget_mb=resident)


def _serve(engine, chunked, prompts=PROMPTS, max_new=8):
    sub = engine.submit_chunked if chunked else engine.submit
    rids = [sub(list(p), max_new=max_new) for p in prompts]
    outs = engine.run()
    return [outs[r] for r in rids]


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's runs, once for the module: every engine case
    (submit and chunked), the preemption base runs and a cache hit."""
    out = {}
    with jops.use_kernels(False):
        for case, (arch, spec, slack, resident) in ENGINE_CASES.items():
            jcfg, _, jparams, _ = models[arch]
            jeng = JEngine(jparams, jcfg,
                           JServeConfig(**_kw(spec, slack, resident)))
            out[case] = (jeng, _serve(jeng, case[1] == "chunked"))
        for arch in (JAMBA, MAMBA):
            jcfg, _, jparams, _ = models[arch]
            jeng = JEngine(jparams, jcfg, JServeConfig(**_preempt_kw()))
            out["preempt", arch] = _serve(jeng, True, PREEMPT_PROMPTS, 3)
            jeng = JEngine(jparams, jcfg, JServeConfig(
                **_preempt_kw(prefix_cache=True)))
            out["hit", arch] = (jeng, [_serve(jeng, True, [HIT_PROMPT], 4)[0]
                                       for _ in range(2)])
    return out


@pytest.mark.parametrize("case", list(ENGINE_CASES),
                         ids=["-".join(c) for c in ENGINE_CASES])
def test_engine_matches_reference(models, reference, case):
    arch, spec, slack, resident = ENGINE_CASES[case]
    chunked = case[1] == "chunked"
    _, cfg, _, params = models[arch]
    jeng, want = reference[case]
    runs = []
    for fused in (True, False):
        eng = Engine(params, cfg, ServeConfig(
            fused=fused, **_kw(spec, slack, resident)), device="cpu")
        runs.append((eng, _serve(eng, chunked)))
    for eng, got in runs:
        assert got == want
        assert len(eng.trace) == len(jeng.trace)
        for rec, jrec in zip(eng.trace, jeng.trace):
            assert set(rec) == set(jrec)
            for k in rec:
                if k == "counts":
                    np.testing.assert_array_equal(rec[k], jrec[k])
                else:
                    assert rec[k] == jrec[k], k
        stats = STATS if eng.scfg.fused else \
            [k for k in STATS if k != "host_syncs"]
        assert {k: eng.stats[k] for k in stats} == \
            {k: jeng.stats[k] for k in stats}
        assert eng.last_step_modeled_s == jeng.last_step_modeled_s
    fused = runs[0][0]
    nb = len(fused.megastep().boundaries)
    assert nb == (4 if arch == JAMBA else 0)
    if arch == JAMBA:
        assert fused.trace and all("modeled_s" in r for r in fused.trace)
    if slack:
        assert fused.stats["deferrals"] > 0
    if resident:
        assert fused.stats["resident_weight_bytes"] > 0
        assert all("hot" in r and "resident" in r for r in fused.trace)


PREEMPT_PROMPTS = ((1, 2, 3, 4, 5), (9, 8, 7))
HIT_PROMPT = [5, 6, 7, 8, 9, 10, 11]


def _preempt_kw(**kw):
    return dict(max_batch=2, max_ctx=16, chunk_tokens=4,
                spec={"strategy": "capacity"}, **kw)


def _ssm_equal(a, b):
    la = [t for s in a for t in s]
    lb = [t for s in b for t in s]
    return len(la) == len(lb) > 0 and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("schedule", [None, "dynamic"],
                         ids=["static", "dynamic"])
@pytest.mark.parametrize("arch", [JAMBA, MAMBA])
def test_mamba_snapshot_evict_restore_exact(models, reference, arch,
                                            schedule, fused):
    """Snapshot -> evict -> (slot reused by an intruder) -> restore is
    bit-exact on the SSM rows, and the decode after it gives the tokens of
    a run never preempted (the reference's)."""
    _, cfg, _, params = models[arch]
    spec = {"strategy": "capacity"}
    if schedule:
        spec["schedule"] = schedule
    kw = _preempt_kw(fused=fused)
    kw["spec"] = spec
    want = reference["preempt", arch]
    base = Engine(params, cfg, ServeConfig(**kw), device="cpu")
    assert _serve(base, True, PREEMPT_PROMPTS, 3) == want
    eng = Engine(params, cfg, ServeConfig(**kw), device="cpu")
    aids = [eng.submit_chunked(list(p), max_new=3) for p in PREEMPT_PROMPTS]
    eng.step()
    eng.step()
    victim = aids[0]
    r = eng.requests[victim]
    assert not r.done and r.generated, "victim must be mid-decode"
    slot = r.slot
    live = statepool.snapshot_ssm(eng.caches, slot)
    resident = eng.stats["resident_state_bytes"]
    handle = eng.preempt(victim)
    assert handle.ssm != () and _ssm_equal(handle.ssm, live)
    assert eng.stats["resident_state_bytes"] >= resident + \
        eng.pool.ssm_bytes_per_row - eng.pool.bytes_per_page * \
        len(handle.page_ids)
    # two intruders fill both slots, so one runs through the victim's rows
    for p in ([3, 1, 2], [4, 4, 9, 4]):
        eng.submit_chunked(p, max_new=2)
    eng.run()
    assert not _ssm_equal(statepool.snapshot_ssm(eng.caches, slot),
                          handle.ssm)
    assert eng.restore(handle) == victim
    slot2 = eng.requests[victim].slot
    assert _ssm_equal(statepool.snapshot_ssm(eng.caches, slot2), handle.ssm)
    outs = eng.run()
    assert [outs[victim], outs[aids[1]]] == want
    assert eng.stats["preemptions"] == 1 and eng.stats["restores"] == 1
    assert eng.pool._ssm_rows_held == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("arch", [JAMBA, MAMBA])
def test_prefix_hit_restores_ssm_snapshot(models, reference, arch, fused):
    """The same prompt twice with the prefix cache: the second admission
    restores the cached SSM rows into a slot the first dirtied and gives
    the uncached tokens; counters equal the reference's."""
    _, cfg, _, params = models[arch]
    jeng, want = reference["hit", arch]
    cold = Engine(params, cfg, ServeConfig(**_preempt_kw(fused=fused)),
                  device="cpu")
    cold_outs = [_serve(cold, True, [HIT_PROMPT], 4)[0] for _ in range(2)]
    eng = Engine(params, cfg, ServeConfig(**_preempt_kw(
        fused=fused, prefix_cache=True)), device="cpu")
    outs = [_serve(eng, True, [HIT_PROMPT], 4)[0] for _ in range(2)]
    assert outs == cold_outs == want
    assert eng.stats["cache_hits"] == jeng.stats["cache_hits"] == 1
    for k in ("cache_misses", "prefill_tokens_saved", "prefill_tokens",
              "resident_state_bytes", "peak_resident_state_bytes"):
        assert eng.stats[k] == jeng.stats[k], k
    assert all(e.ssm != () for e in eng.pool.entries.values())


# ---------------------------------------------------------------------------
# the serve CLI, the simulator's spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("traffic", [False, True], ids=["batch", "traffic"])
@pytest.mark.parametrize("arch", [JAMBA, MAMBA])
def test_serve_cli_dry_run_on_cpu(arch, traffic, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--dry-run"]
    if traffic:
        argv += ["--traffic", "--prefix-cache", "--preempt-depth", "0",
                 "--max-batch", "2", "--traffic-requests", "6",
                 "--traffic-mix", "poisson+zipf_prefix"]
    serve.main(argv)
    out = capsys.readouterr().out
    if traffic:
        assert "traffic dry-run OK" in out and "6 completed" in out
        assert "2 preemptions / 2 restores" in out
    else:
        assert "dry-run OK" in out


def test_spec_from_config_matches_reference_on_jamba():
    """Jamba's MoE every other layer: the simulator's spec (num_layers
    counts every layer, as the reference's) and the engine's cost model."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for jcfg, cfg in ((jget(JAMBA), get_config(JAMBA)),
                      (jreduced(JAMBA), reduced_config(JAMBA))):
        assert hardware.spec_from_config(cfg).__dict__ == \
            jhw.spec_from_config(jcfg).__dict__

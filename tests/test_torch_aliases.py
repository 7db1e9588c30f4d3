"""The reference's remaining public names and knobs in the port, each held
against the JAX package on the CPU.

``trajectory.static_order``, ``LoadTracker.load_vector`` (1e-12),
``build_schedule(predicted_s=)``, ``Plan.breakdown``, the deprecated
``pick_mode`` (equal over ``VALIDATION_SWEEP``, one warning a process,
also ``core.fse_dp.pick_mode``), the three sweeps (``==``), the deprecated
``*_moe_3d`` entry points (``strategy.execute``'s bits on one rank, one
warning each a process; called through ``getattr`` only, as the
reference's own test does), ``capacity_of``, ``meshctx.batch_axes`` over a
``ProcessMesh`` and a ``MeshShape``, ``moe_block(impl=)`` (``spec=``'s
bits), ``attention_decode(update_cache=False)`` (the cache untouched; fp32
2e-5, bf16 3e-2), ``route(jitter=, generator=)`` (a ``torch.Generator``
in place of the JAX key: the noise is not the reference's, its form is),
``global_norm(tree=)``, the ``ServeConfig`` aliases ``moe_impl`` /
``autotune``, and the package exports, each package importable first in a
fresh interpreter with ``jax`` and ``repro`` blocked.  Inputs are numpy
arrays from a seed; weights cross through ``repro_torch.bridge``.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import autotune as jat
from repro.core import gating as jgating
from repro.core import strategy as jstrat
from repro.core import trajectory as jtraj
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.parallel import meshctx as jmeshctx
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs.base import MoEConfig
from repro_torch.core import (autotune, baselines, fse_dp, gating, strategy,
                              trajectory)
from repro_torch.models import attention, moe as moe_mod
from repro_torch.optim import adamw
from repro_torch.parallel import meshctx
from repro_torch.serving import engine

REPO = Path(__file__).resolve().parent.parent
D = 16
MOE_TOL = 2e-5
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SHIMS = (("fse_dp", fse_dp), ("ep", baselines), ("tp", baselines))


def _moe(E=8, k=2, de=32, cf=4.0, act="swiglu", seed=0):
    kw = dict(num_experts=E, top_k=k, d_expert=de, capacity_factor=cf)
    jm = JMoEConfig(**kw)
    jparams = jmoe.moe_init(jax.random.PRNGKey(seed), D, jm, act, jnp.float32)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return MoEConfig(**kw), jm, params, jparams


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# trajectory and the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E", [1, 7, 32])
def test_static_order(E):
    assert trajectory.static_order(E) == tuple(range(E)) == \
        jtraj.static_order(E)


def test_load_vector_matches_reference():
    rng = np.random.default_rng(3)
    t, jt = trajectory.LoadTracker(12, decay=0.7), jtraj.LoadTracker(12,
                                                                     decay=0.7)
    assert t.load_vector() is None and jt.load_vector() is None
    for _ in range(5):
        c = rng.integers(0, 20, size=12)
        t.update(c)
        jt.update(c)
        np.testing.assert_allclose(t.load_vector(), jt.load_vector(),
                                   rtol=0, atol=1e-12)
    zero = trajectory.LoadTracker(4)
    zero.update([0, 0, 0, 0])
    assert zero.load_vector() is None


@pytest.mark.parametrize("policy", ["static", "dynamic"])
def test_build_schedule_predicted_s(policy):
    counts = [5, 0, 9, 2, 2, 7]
    plan = autotune.Plan(mode="slice", micro_slices=2, predicted_s=1.5e-4)
    jplan = jat.Plan(mode="slice", micro_slices=2, predicted_s=1.5e-4)
    s = trajectory.build_schedule(counts, policy=policy, plan=plan,
                                  predicted_s=2.5e-4)
    js = jtraj.build_schedule(counts, policy=policy, plan=jplan,
                              predicted_s=2.5e-4)
    for f in ("policy", "order", "pairs", "load", "predicted_s"):
        assert getattr(s, f) == getattr(js, f), f
    assert s.plan is plan


def _profiles(P):
    from repro.sim import hardware as jhw
    from repro_torch.sim import hardware as hw
    return (autotune.HardwareProfile.from_chiplet(hw.scaled(2, P // 2)),
            jat.HardwareProfile.from_chiplet(jhw.scaled(2, P // 2)))


@pytest.mark.parametrize("point", autotune.VALIDATION_SWEEP[:6])
def test_plan_breakdown_matches_reference(point):
    B, S, E, de, P = point
    p, jp = _profiles(P)
    kw = dict(num_experts=E, top_k=2, d_expert=de, micro_slices=4)
    plan = autotune.plan_moe(B, S, 512, MoEConfig(**kw), "swiglu", P,
                             profile=p)
    jplan = jat.plan_moe(B, S, 512, JMoEConfig(**kw), "swiglu", P,
                         profile=jp)
    assert plan.breakdown == jplan.breakdown
    assert plan.breakdown == dict(plan.per_mode_s) and plan.breakdown


def test_sweeps_are_the_reference_sweeps():
    assert autotune.VALIDATION_SWEEP == jat.VALIDATION_SWEEP
    assert strategy.FAMILY_SWEEP == jstrat.FAMILY_SWEEP
    assert strategy.HYBRID_SWEEP == jstrat.HYBRID_SWEEP


def test_pick_mode_matches_reference_and_warns_once(monkeypatch):
    monkeypatch.setattr(jat, "_PICK_MODE_WARNED", True)    # silent reference
    monkeypatch.setattr(autotune, "_PICK_MODE_WARNED", False)
    assert fse_dp.pick_mode is autotune.pick_mode
    with pytest.warns(DeprecationWarning, match="pick_mode"):
        fse_dp.pick_mode(4, 16, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for (B, S, E, de, P) in autotune.VALIDATION_SWEEP:
            assert autotune.pick_mode(B, S, P) == jat.pick_mode(B, S, P)
    import repro_torch.core as core_pkg
    assert not hasattr(core_pkg, "pick_mode")


# ---------------------------------------------------------------------------
# the deprecated entry points, capacity_of, moe_block(impl=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,module", SHIMS, ids=[s[0] for s in SHIMS])
def test_deprecated_entry_is_execute(name, module, monkeypatch):
    monkeypatch.setattr(strategy, "_ENTRY_WARNED", set())
    moe, _, params, _ = _moe()
    x = torch.from_numpy(_x((2, 6, D)))
    entry = getattr(module, f"{name}_moe_3d")
    import repro_torch.core as core_pkg
    assert getattr(core_pkg, f"{name}_moe_3d") is entry
    with pytest.warns(DeprecationWarning, match=f"{name}_moe_3d"):
        y, aux = entry(params, x, moe, "swiglu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")         # the second call is silent
        y2, aux2 = entry(params, x, moe, "swiglu")
    want, want_aux = strategy.execute(name, params, x, moe, "swiglu")
    for got in (y, y2):
        assert torch.equal(got, want)
    assert torch.equal(aux, want_aux) and torch.equal(aux2, want_aux)


@pytest.mark.parametrize("T", [1, 7, 64, 1000])
def test_capacity_of_matches_reference(T):
    for kw in (dict(num_experts=8, top_k=2, d_expert=8),
               dict(num_experts=32, top_k=8, d_expert=8, capacity_factor=1.0),
               dict(num_experts=6, top_k=1, d_expert=8, capacity_factor=2.5)):
        assert moe_mod.capacity_of(T, MoEConfig(**kw)) == \
            jmoe.capacity_of(T, JMoEConfig(**kw))


@pytest.mark.parametrize("impl", ["capacity", "dense", "fse_dp"])
def test_moe_block_impl_alias(impl):
    moe, jm, params, jparams = _moe()
    xn = _x((2, 5, D))
    x = torch.from_numpy(xn)
    got = moe_mod.moe_block(params, x, moe, "swiglu", impl=impl)
    assert torch.equal(got, moe_mod.moe_block(params, x, moe, "swiglu",
                                              spec=impl))
    want = np.asarray(jmoe.moe_block(jparams, jnp.asarray(xn), jm, "swiglu",
                                     impl=impl))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MOE_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# meshes, decode attention, routing noise, the optimizer's norm
# ---------------------------------------------------------------------------


def test_batch_axes():
    mesh = meshctx.ProcessMesh(
        axis_names=("data", "model"), axis_sizes=(2, 4), coords=(0, 0),
        groups=(None, None), lines=((0, 4), (0, 1, 2, 3)), rank=0)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for axis in ("model", "data"):
        assert meshctx.batch_axes(mesh, axis) == \
            jmeshctx.batch_axes(jmesh, axis)
    assert meshctx.batch_axes(mesh) == ("data",)
    pod = meshctx.MeshShape(("pod", "data", "model"), (2, 16, 16))
    jpod = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert meshctx.batch_axes(pod) == jmeshctx.batch_axes(jpod) == \
        ("pod", "data")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_without_cache_update(dtype):
    B, S, H, KV, HD = 3, 8, 4, 2, 8
    rng = np.random.default_rng(5)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (D, H * HD)), ("wk", (D, KV * HD)),
                      ("wv", (D, KV * HD)), ("wo", (H * HD, D)))}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    cache_len = np.array([0, 3, S + 2], np.int32)     # the last one past S
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=10000.0)
    jout, jcache = jattn.attention_decode(
        {n: jnp.asarray(a, jd) for n, a in w.items()}, jnp.asarray(x, jd),
        jattn.KVCache(jnp.asarray(k, jd), jnp.asarray(v, jd)),
        jnp.asarray(cache_len), update_cache=False, **kw)
    cache = attention.KVCache(torch.from_numpy(k).to(td),
                              torch.from_numpy(v).to(td))
    before = (cache.k.clone(), cache.v.clone())
    out, new = attention.attention_decode(
        {n: torch.from_numpy(a).to(td) for n, a in w.items()},
        torch.from_numpy(x).to(td), cache,
        torch.from_numpy(cache_len).long(), update_cache=False, **kw)
    assert torch.equal(cache.k, before[0]) and torch.equal(cache.v, before[1])
    assert torch.equal(new.k, before[0]) and torch.equal(new.v, before[1])
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=ATTN_TOL[dtype] * np.abs(want).max())
    # attends over [0, min(cache_len, S - 1)]: keys past it do not count
    far = attention.KVCache(cache.k.clone(), cache.v.clone())
    far.k[0, 1:] = 100.0
    far.v[0, 1:] = -100.0
    out_far, _ = attention.attention_decode(
        {n: torch.from_numpy(a).to(td) for n, a in w.items()},
        torch.from_numpy(x).to(td), far,
        torch.from_numpy(cache_len).long(), update_cache=False, **kw)
    assert torch.equal(out_far[0], out[0])
    # and with the update, the token's own K/V are written into a copy
    out_upd, upd = attention.attention_decode(
        {n: torch.from_numpy(a).to(td) for n, a in w.items()},
        torch.from_numpy(x).to(td), cache,
        torch.from_numpy(cache_len).long(), **kw)
    assert torch.equal(cache.k, before[0])
    assert not torch.equal(upd.k, before[0])


def _router(T=10, E=6, seed=4):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)
    return w, x


def test_route_jitter_zero_keeps_the_bits():
    w, x = _router()
    params, xt = {"w_router": torch.from_numpy(w)}, torch.from_numpy(x)
    base = gating.route(params, xt, top_k=2)
    for r in (gating.route(params, xt, top_k=2, jitter=0.0,
                           generator=torch.Generator().manual_seed(1)),
              gating.route(params, xt, top_k=2, jitter=0.5)):
        for a, b in zip(r, base):
            assert torch.equal(a, b)
    jr = jgating.route({"w_router": jnp.asarray(w)}, jnp.asarray(x), top_k=2)
    np.testing.assert_array_equal(base.indices.numpy(), np.asarray(jr.indices))


def test_route_jitter_is_seeded_noise_of_the_reference_form():
    T, E, J = 10, 6, 0.7
    w, x = _router(T, E)
    params, xt = {"w_router": torch.from_numpy(w)}, torch.from_numpy(x)
    a = gating.route(params, xt, top_k=2, jitter=J,
                     generator=torch.Generator().manual_seed(11))
    b = gating.route(params, xt, top_k=2, jitter=J,
                     generator=torch.Generator().manual_seed(11))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    noise = torch.randn((T, E), generator=torch.Generator().manual_seed(11))
    assert not torch.equal(a.probs, gating.route(params, xt, top_k=2).probs)
    # the reference's route on logits x w + J * noise: x extended by the
    # identity and w by J * noise give those logits in one product
    xe = np.concatenate([x, np.eye(T, dtype=np.float32)], 1)
    we = np.concatenate([w, J * noise.numpy()], 0)
    jr = jgating.route({"w_router": jnp.asarray(we)}, jnp.asarray(xe),
                       top_k=2)
    np.testing.assert_array_equal(a.indices.numpy(), np.asarray(jr.indices))
    np.testing.assert_allclose(a.probs.numpy(), np.asarray(jr.probs),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.weights.numpy(), np.asarray(jr.weights),
                               rtol=0, atol=1e-6)


def test_global_norm_tree_keyword():
    rng = np.random.default_rng(8)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": (rng.standard_normal(5).astype(np.float32),
                    rng.standard_normal((2, 2)).astype(np.float32))}
    tree = {"a": torch.from_numpy(arrays["a"]),
            "b": tuple(torch.from_numpy(t) for t in arrays["b"])}
    jtree = jax.tree.map(jnp.asarray, arrays)
    np.testing.assert_allclose(float(adamw.global_norm(tree=tree)),
                               float(jadamw.global_norm(tree=jtree)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# ServeConfig's aliases and the package exports
# ---------------------------------------------------------------------------


def test_serveconfig_aliases_warn_once_and_merge(monkeypatch):
    monkeypatch.setattr(engine, "_ALIAS_WARNED", set())
    monkeypatch.setattr(jengine, "_ALIAS_WARNED", {"moe_impl", "autotune"})
    for kw, match in ((dict(moe_impl="dense"), "moe_impl"),
                      (dict(autotune="off"), "autotune")):
        with pytest.warns(DeprecationWarning, match=match):
            sc = engine.ServeConfig(**kw)
        want = jengine.ServeConfig(**kw).spec
        assert (sc.spec.strategy, sc.spec.autotune) == \
            (want.strategy, want.autotune)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sc = engine.ServeConfig(moe_impl="dense", autotune="off")
        assert (sc.spec.strategy, sc.spec.autotune) == ("dense", "off")
        assert engine.ServeConfig(spec="capacity").spec == \
            engine.ServeConfig().spec


def test_packages_import_first_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "pkgs = ['repro_torch'] + [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.') if m.ispkg]\n"
        "for name in pkgs:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(name)\n"
        "print(len(pkgs))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == 13
    from repro_torch import kernels, models
    from repro_torch.kernels import ops
    assert kernels.flash_ops is ops and kernels.ssd_ops is ops
    assert models.loss_fn is models.api.loss_fn

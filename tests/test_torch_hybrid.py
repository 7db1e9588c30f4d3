"""Two-tier hybrid placement and the resident weight tier: port vs JAX.

* ``moe_hybrid`` against the reference's on the same weights and inputs
  (fp32 2e-5, bf16 3e-2; one-hot and sorted dispatch; with and without a
  host schedule), and within the port bit for bit ``moe_capacity`` for
  every hot width;
* ``hybrid_cost``, ``ServingCostModel.layer_s(hot=...)`` on a two-tier
  profile, ``StrategyContext`` and the hybrid plan (analytic and the
  homogeneous fallback) equal to the reference's, and the same
  ``ValueError``s without a near-memory tier;
* an engine under ``hybrid`` and with ``resident_budget_mb``: tokens, the
  trace (``hot``, ``resident``, ``modeled_s``) and the statistics equal
  to the reference engine's, fused equal to eager;
* ``serve --strategy hybrid --hot-experts 4 --resident-budget-mb 0.1
  --device cpu --dry-run`` prints the weight-tier line.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import autotune as jautotune
from repro.core import gating as jgating
from repro.core import strategy as jstrat
from repro.core import trajectory as jtraj
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.sim import hardware as jhw
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import autotune, gating, strategy, trajectory
from repro_torch.kernels import ops as kops
from repro_torch.models import moe
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sim import hardware as hw

REPO = Path(__file__).resolve().parent.parent
ARCH = "granite-moe-1b-a400m"
# the reference's MoE-block tolerances (max abs over max abs)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
STATS = ("tokens_emitted", "iterations", "deferrals", "expert_loads",
         "expert_loads_saved", "dynamic_schedules", "host_syncs",
         "prefill_chunks", "prefill_tokens", "resident_weight_bytes",
         "ddr_bytes_saved", "hybrid_repartitions")


def _case(dtype="float32", T=24, d=16, E=8, m=32, k=2, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": {"w_router": rng.standard_normal((d, E)).astype(np.float32)},
         "w_gate": rng.standard_normal((E, d, m)).astype(np.float32) * 0.3,
         "w_up": rng.standard_normal((E, d, m)).astype(np.float32) * 0.3,
         "w_down": rng.standard_normal((E, m, d)).astype(np.float32) * 0.3}
    x = rng.standard_normal((T, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = {"router": {"w_router": jnp.asarray(p["router"]["w_router"], jdt)},
          **{n: jnp.asarray(v, jdt) for n, v in p.items() if n != "router"}}
    tp = {"router": {"w_router": torch.from_numpy(p["router"]["w_router"])
                     .to(tdt)},
          **{n: torch.from_numpy(v).to(tdt) for n, v in p.items()
             if n != "router"}}
    kw = dict(num_experts=E, top_k=k, d_expert=m, capacity_factor=1.25)
    return (jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), jp, tp,
            JMoEConfig(**kw), MoEConfig(**kw))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host_schedule", [False, True],
                         ids=["in-call", "host"])
@pytest.mark.parametrize("sorted_", [False, True], ids=["one-hot", "sorted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_hybrid_matches_reference(dtype, sorted_, host_schedule):
    jx, x, jp, tp, jcfg, cfg = _case(dtype)
    r = gating.route(tp["router"], x, top_k=cfg.top_k)
    jr = jgating.route(jp["router"], jx, top_k=jcfg.top_k)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    counts = gating.expert_token_counts(r).numpy()
    sched = trajectory.build_schedule(counts) if host_schedule else None
    jsched = jtraj.build_schedule(counts) if host_schedule else None
    with jops.use_kernels(False), jmoe.use_sorted_dispatch(sorted_):
        want = np.asarray(jmoe.moe_hybrid(jp, jx, jr, jcfg, "swiglu",
                                          hot_experts=3, schedule=jsched),
                          np.float32)
    with kops.use_kernels(False), moe.use_sorted_dispatch(sorted_):
        got = moe.moe_hybrid(tp, x, r, cfg, "swiglu", hot_experts=3,
                             schedule=sched)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("sorted_", [False, True], ids=["one-hot", "sorted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_equals_capacity_bitwise(dtype, sorted_):
    """Every hot width, the single-tier extremes 0 and E included, with
    the split's order from the call's counts and from a host schedule
    (its own load and a reversed one): the capacity path's bits."""
    _, x, _, tp, _, cfg = _case(dtype, T=40, E=8, seed=3)
    r = gating.route(tp["router"], x, top_k=cfg.top_k)
    counts = gating.expert_token_counts(r).numpy()
    with kops.use_kernels(False), moe.use_sorted_dispatch(sorted_):
        want = moe.moe_capacity(tp, x, r, cfg, "swiglu")
        for H in range(cfg.num_experts + 1):
            for sched in (None, trajectory.build_schedule(counts),
                          trajectory.build_schedule(counts[::-1].copy())):
                got = moe.moe_hybrid(tp, x, r, cfg, "swiglu", hot_experts=H,
                                     schedule=sched)
                assert torch.equal(got, want), (H, sched)
        y_h, _ = strategy.get_strategy("hybrid").execute(tp, x[None], cfg,
                                                         "swiglu")
        y_c, _ = strategy.get_strategy("capacity").execute(tp, x[None], cfg,
                                                           "swiglu")
    assert torch.equal(y_h, y_c)


def test_hybrid_strategy_takes_the_plan_width(monkeypatch):
    """``run`` takes H from the schedule's plan, else ``default_hot(E)``."""
    _, x, _, tp, _, cfg = _case()
    seen = []
    real = moe._expert_ffn_tiered
    monkeypatch.setattr(moe, "_expert_ffn_tiered",
                        lambda p, xe, act, hot: seen.append(hot)
                        or real(p, xe, act, hot))
    r = gating.route(tp["router"], x, top_k=cfg.top_k)
    hyb = strategy.get_strategy("hybrid")
    plan = autotune.Plan(mode="hybrid", family="hybrid", micro_slices=1,
                         hot_experts=5)
    counts = gating.expert_token_counts(r).numpy()
    for sched in (None, trajectory.DYNAMIC,
                  trajectory.build_schedule(counts, plan=plan),
                  trajectory.LoadTracker(8).schedule(plan=plan)):
        hyb.run(tp, x, r, cfg, "swiglu", sched)
    assert seen == [strategy.default_hot(8)] * 2 + [5, strategy.default_hot(8)]
    assert strategy.default_hot(32) == jstrat.default_hot(32) == 8
    assert [strategy.default_hot(E) for E in range(1, 9)] == \
        [jstrat.default_hot(E) for E in range(1, 9)]


# ---------------------------------------------------------------------------
# the cost model and the plan
# ---------------------------------------------------------------------------


def _profiles(P):
    base = {2: (hw.scaled(1, 2), jhw.scaled(1, 2)),
            4: (hw.scaled(2, 2), jhw.scaled(2, 2)),
            8: (hw.scaled(2, 4), jhw.scaled(2, 4))}[P]
    return (autotune.HardwareProfile.from_chiplet(hw.with_ndp(base[0])),
            jautotune.HardwareProfile.from_chiplet(jhw.with_ndp(base[1])))


def test_hybrid_cost_matches_reference():
    for (B, S, E, de, P, zs) in strategy.HYBRID_SWEEP:
        prof, jprof = _profiles(P)
        assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
        loads = None
        if zs > 0:
            rng = np.random.default_rng(0)
            p = rng.permutation(E)
            w = np.arange(1, E + 1, dtype=np.float64) ** -zs
            loads = tuple(float(v) for v in (w / w.sum())[p])
        for hot_n in (None, 0, 1, E // 3, E, E + 5):
            for wb in (None, 1):
                args = (B, S, 512, E, de, 2, 1.25, 3, P)
                kw = dict(load=loads, weight_bytes=wb, hot_n=hot_n)
                assert autotune.hybrid_cost(*args, prof, 2, **kw) == \
                    jautotune.hybrid_cost(*args, jprof, 2, **kw)


def test_layer_s_hot_matches_reference():
    cfg, jcfg = reduced_config(ARCH), jreduced(ARCH)
    rng = np.random.default_rng(0)
    E = cfg.moe.num_experts
    for base, jbase in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                        (hw.PROTOTYPE_2X2_NDP, jhw.PROTOTYPE_2X2_NDP)):
        for wb in (None, 1):
            cm = autotune.ServingCostModel.from_config(
                cfg, autotune.HardwareProfile.from_chiplet_array(base), wb)
            jcm = jautotune.ServingCostModel.from_config(
                jcfg, jautotune.HardwareProfile.from_chiplet_array(jbase), wb)
            for counts in (np.zeros(E, np.int64), rng.integers(0, 9, E),
                           rng.integers(0, 2, E) * 40):
                for hot in (None, [], [0], list(range(E // 2)),
                            list(range(E))):
                    for dyn in (False, True):
                        got = cm.layer_s(counts, dynamic=dyn, hot=hot,
                                         resident=1)
                        assert got == jcm.layer_s(counts, dynamic=dyn,
                                                  hot=hot, resident=1)
                        if base.ndp is None:
                            assert got == cm.layer_s(counts, dynamic=dyn,
                                                     resident=1)


def test_hybrid_plan_matches_reference():
    moe_kw = dict(num_experts=64, d_expert=1408, top_k=6)
    prof, jprof = _profiles(4)
    for load in (None, tuple(np.full(64, 1 / 64))):
        for profile, jprofile in ((prof, jprof), (None, None)):
            ctx = strategy.StrategyContext(
                B=2, S=1, d_model=512, moe=MoEConfig(**moe_kw),
                activation="swiglu", P=4, profile=profile, load=load)
            jctx = jstrat.StrategyContext(
                B=2, S=1, d_model=512, moe=JMoEConfig(**moe_kw),
                activation="swiglu", P=4, profile=jprofile, load=load)
            got = strategy.get_strategy("hybrid").plan(ctx)
            want = jstrat.get_strategy("hybrid").plan(jctx)
            # the port's Plan adds the Hopper planner's ``tiles`` (none
            # for a hybrid plan) to the reference's fields
            assert dataclasses.asdict(got) == dict(dataclasses.asdict(want),
                                                   tiles=None)
            assert got.source == ("fallback" if profile is None
                                  else "analytic")
    x = torch.zeros((3, 5, 16), dtype=torch.bfloat16)
    ctx = strategy.StrategyContext.from_inputs(x, MoEConfig(**moe_kw),
                                               "swiglu")
    jctx = jstrat.StrategyContext.from_inputs(
        jnp.zeros((3, 5, 16), jnp.bfloat16), JMoEConfig(**moe_kw), "swiglu")
    assert (ctx.B, ctx.S, ctx.d_model, ctx.P, ctx.dtype_bytes,
            ctx.weight_bytes) == (jctx.B, jctx.S, jctx.d_model, jctx.P,
                                  jctx.dtype_bytes, jctx.weight_bytes)
    assert strategy.FAMILIES == jstrat.FAMILIES
    assert strategy.BASE_FAMILIES == jstrat.BASE_FAMILIES


def test_no_near_memory_tier_raises():
    flat = autotune.HardwareProfile.from_chiplet()
    with pytest.raises(ValueError, match="near-memory"):
        autotune.hybrid_cost(8, 1, 512, 16, 512, 2, 1.25, 3, 4, flat)
    with pytest.raises(ValueError, match="near-memory"):
        jautotune.hybrid_cost(8, 1, 512, 16, 512, 2, 1.25, 3, 4,
                              jautotune.HardwareProfile.from_chiplet())
    for bad in (-1.0, -0.5):
        with pytest.raises(ValueError, match="resident_budget_mb"):
            ServeConfig(resident_budget_mb=bad)
        with pytest.raises(ValueError, match="resident_budget_mb"):
            JServeConfig(resident_budget_mb=bad)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(2), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


PROMPTS = ([5, 9, 2, 77, 31], [100, 3, 64], [7, 7, 8, 1, 2, 3, 4], [60, 61])


def _serve(eng, chunked):
    sub = eng.submit_chunked if chunked else eng.submit
    rids = [sub(list(p), max_new=8) for p in PROMPTS]
    outs = eng.run()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("spec,tiers,chunked", [
    ({"strategy": "hybrid", "schedule": "dynamic"},
     dict(hot_experts=2, resident_budget_mb=0.1), True),
    ({"strategy": "hybrid"}, dict(), False),
    ({"strategy": "capacity", "schedule": "dynamic"},
     dict(resident_budget_mb=0.2, buffering_slack=0.2), True),
])
def test_engine_tiers_match_reference(weights, spec, tiers, chunked):
    jcfg, cfg, jparams, params = weights
    kw = dict(max_batch=4, max_ctx=32, page_size=4, chunk_tokens=3,
              spec=spec, **tiers)
    with jops.use_kernels(False):
        jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
        want = _serve(jeng, chunked)
    eng = Engine(params, cfg, ServeConfig(**kw), device="cpu")
    got = _serve(eng, chunked)
    eager = Engine(params, cfg, ServeConfig(**kw, fused=False), device="cpu")
    assert _serve(eager, chunked) == got == want
    assert eng._n_resident == jeng._n_resident
    assert eng._n_hot == jeng._n_hot
    assert len(eng.trace) == len(jeng.trace) == len(eager.trace)
    for rec, jrec, erec in zip(eng.trace, jeng.trace, eager.trace):
        for key in ("iter", "layer", "phase", "schedule", "modeled_s",
                    "resident", "hot", "trajectory", "event"):
            assert rec.get(key) == jrec.get(key) == erec.get(key), key
        if "counts" in rec:
            np.testing.assert_array_equal(rec["counts"], jrec["counts"])
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    assert eng.last_step_modeled_s == jeng.last_step_modeled_s
    moe_recs = [r for r in eng.trace if "counts" in r]
    if spec["strategy"] == "hybrid":
        assert all(len(r["hot"]) == eng._n_hot for r in moe_recs)
    else:
        assert all("hot" not in r for r in moe_recs)
    if tiers.get("resident_budget_mb"):
        n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
        assert eng.stats["resident_weight_bytes"] == \
            eng._n_resident * n_moe * eng.cost_model.expert_bytes > 0
        assert eng.stats["ddr_bytes_saved"] > 0
        assert all(len(r["resident"]) == eng._n_resident for r in moe_recs)


def test_serve_cli_weight_tier_dry_run():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--dry-run", "--strategy", "hybrid",
         "--hot-experts", "4", "--resident-budget-mb", "0.1"],
        env=env, timeout=300, capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert '"strategy": "hybrid"' in out.stdout, out.stdout
    assert "weight tier  float32 weights, 98304 resident expert bytes " \
           "(2/layer), 98304 DDR bytes saved" in out.stdout, out.stdout

"""Routing, schedules, strategies and the MoE block: port vs JAX, on the CPU.

Integer outputs (expert ids, counts, orders) must be identical; float
outputs of the MoE block agree within 1e-5 (fp32, both sides accumulate
in fp32 in different orders).  Within the port, a dynamic trajectory
must equal the static one bit for bit.
"""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import gating as jgating
from repro.core import policies as jpolicies
from repro.core import strategy as jstrategy
from repro.core import trajectory as jtraj
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating, policies, strategy, trajectory
from repro_torch.models import moe

REPO = Path(__file__).resolve().parent.parent
MOE_TOL = 1e-5


def _router_case(T=9, d=16, E=8, seed=0, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((d, E)).astype(np.float32) * 0.5
    if tie:                      # duplicate expert columns -> exact prob ties
        w[:, 5] = w[:, 2]
        w[:, 7] = w[:, 2]
    return x, w


@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_reference(tie):
    x, w = _router_case(tie=tie)
    jr = jgating.route({"w_router": jnp.asarray(w)}, jnp.asarray(x), top_k=3)
    r = gating.route({"w_router": torch.from_numpy(w)}, torch.from_numpy(x),
                     top_k=3)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    for a, b in ((r.weights, jr.weights), (r.probs, jr.probs),
                 (r.combine, jr.combine)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    mask = np.arange(x.shape[0]) % 3 != 0
    np.testing.assert_array_equal(
        gating.expert_token_counts(r, torch.from_numpy(mask)).numpy(),
        np.asarray(jgating.expert_token_counts(jr, jnp.asarray(mask))))
    np.testing.assert_allclose(
        gating.aux_load_balance_loss(r, 8).item(),
        float(jgating.aux_load_balance_loss(jr, 8)), rtol=1e-6)


COUNTS = [[0, 0, 0, 0], [3], [5, 0, 2, 2, 7, 0, 1, 9], [4, 4, 4, 1, 0, 4],
          list(np.random.default_rng(3).integers(0, 6, size=32))]


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: f"E{len(c)}")
def test_orders_match_reference(counts):
    c = np.asarray(counts, np.int64)
    assert policies.paired_load_order(c) == jpolicies.paired_load_order(c)
    assert policies.expert_pairs(c) == jpolicies.expert_pairs(c)
    np.testing.assert_array_equal(
        trajectory.traced_order(torch.from_numpy(c)).numpy(),
        np.asarray(jtraj.traced_order(jnp.asarray(c))))
    s, js = trajectory.build_schedule(c), jtraj.build_schedule(c)
    assert (s.order, s.pairs, s.load) == (js.order, js.pairs, js.load)


def test_load_tracker_and_token_buffer_match_reference():
    rng = np.random.default_rng(4)
    t, jt = trajectory.LoadTracker(8, decay=0.7), jtraj.LoadTracker(8, decay=0.7)
    s, js = t.schedule(), jt.schedule()
    assert (s.policy, s.order, s.load) == (js.policy, js.order, js.load)
    for _ in range(5):
        c = rng.integers(0, 5, size=8)
        np.testing.assert_array_equal(t.update(c), jt.update(c))
        s, js = t.schedule(), jt.schedule()
        assert (s.policy, s.order, s.pairs, s.load) == \
            (js.policy, js.order, js.pairs, js.load)
    p, jp = (mod.TokenBufferPolicy.from_slack(0.3, theta_min=2)
             for mod in (policies, jpolicies))
    for step in range(12):
        p.on_forward_pass("r")
        jp.on_forward_pass("r")
        acts, counts = [step % 8, 3], rng.integers(0, 4, size=8)
        assert p.should_defer("r", acts, counts) == \
            jp.should_defer("r", acts, counts)
    assert dataclasses.astuple(p.states["r"]) == \
        dataclasses.astuple(jp.states["r"])


def _moe_case(T=7, d=16, E=4, m=8, k=2, seed=0, activation="swiglu"):
    rng = np.random.default_rng(seed)
    p = {"router": {"w_router": rng.standard_normal((d, E)).astype(np.float32)},
         "w_up": rng.standard_normal((E, d, m)).astype(np.float32) * 0.3,
         "w_down": rng.standard_normal((E, m, d)).astype(np.float32) * 0.3}
    if activation == "swiglu":
        p["w_gate"] = rng.standard_normal((E, d, m)).astype(np.float32) * 0.3
    x = rng.standard_normal((T, d)).astype(np.float32)
    jp = {"router": {"w_router": jnp.asarray(p["router"]["w_router"])},
          **{k_: jnp.asarray(v) for k_, v in p.items() if k_ != "router"}}
    tp = {"router": {"w_router": torch.from_numpy(p["router"]["w_router"])},
          **{k_: torch.from_numpy(v) for k_, v in p.items() if k_ != "router"}}
    kw = dict(num_experts=E, top_k=k, d_expert=m, capacity_factor=1.0)
    return x, jp, tp, JMoEConfig(**kw), MoEConfig(**kw)


@pytest.mark.parametrize("schedule", ["static", "dynamic"])
@pytest.mark.parametrize("name", ["dense", "capacity"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_block_matches_reference(name, schedule, activation):
    x, jp, tp, jcfg, cfg = _moe_case(activation=activation)
    sched = None if schedule == "static" else "dynamic"
    with jops.use_kernels(False):
        want = np.asarray(jmoe.moe_block(
            jp, jnp.asarray(x), jcfg, activation,
            spec=jstrategy.ExecutionSpec(strategy=name, schedule=sched)))
    got = moe.moe_block(tp, torch.from_numpy(x), cfg, activation,
                        spec=strategy.ExecutionSpec(strategy=name,
                                                    schedule=sched))
    np.testing.assert_allclose(got.numpy(), want, rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("name", ["dense", "capacity"])
def test_dynamic_equals_static_bitwise(name):
    x, _, tp, _, cfg = _moe_case(T=11, E=8, seed=5)
    xt = torch.from_numpy(x)
    r = gating.route(tp["router"], xt, top_k=cfg.top_k)
    fn = moe.moe_dense if name == "dense" else \
        (lambda *a, **k: moe.moe_capacity(a[0], a[1], a[2], cfg, *a[3:], **k))
    static = fn(tp, xt, r, "swiglu", schedule=None)
    counts = gating.expert_token_counts(r).numpy()
    for sched in (trajectory.DYNAMIC, trajectory.build_schedule(counts),
                  trajectory.build_schedule(counts[::-1].copy())):
        assert torch.equal(fn(tp, xt, r, "swiglu", schedule=sched), static)


def test_dispatch_masks_match_reference():
    x, jp, tp, _, _ = _moe_case(T=9, E=4, k=2)
    r = gating.route(tp["router"], torch.from_numpy(x), top_k=2)
    jr = jgating.route(jp["router"], jnp.asarray(x), top_k=2)
    for C in (2, 5):                                   # C=2 drops tokens
        d, c = moe.dispatch_masks(r, 9, 4, C)
        jd, jc = jmoe.dispatch_masks(jr, 9, 4, C)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)


def test_execution_spec_json_roundtrip():
    path = REPO / "examples" / "moe-spec.json"
    spec, jspec = strategy.ExecutionSpec.load(str(path)), \
        jstrategy.ExecutionSpec.load(str(path))
    assert spec.to_json() == jspec.to_json()
    assert strategy.ExecutionSpec.from_json(spec.to_json()) == spec
    assert spec.resolve(phase="decode") == jspec.resolve(phase="decode")
    assert spec.resolve(phase="prefill", layer=0) == \
        jspec.resolve(phase="prefill", layer=0)
    d = {"strategy": "capacity", "weight_dtype": "fp8", "schedule": "dynamic",
         "layer_overrides": {"3": "dense"}}
    assert strategy.ExecutionSpec.from_dict(d).to_json() == \
        jstrategy.ExecutionSpec.from_dict(d).to_json()
    with pytest.raises(ValueError):
        strategy.ExecutionSpec.from_dict({"strategy": "capacity", "bogus": 1})


@pytest.mark.parametrize("name", ["fse_dp", "ep", "tp", "hybrid", "auto"])
def test_unported_strategies_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        strategy.get_strategy(name)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        strategy.ExecutionSpec(strategy=name).validate()
    x, _, tp, _, cfg = _moe_case()
    with pytest.raises(NotImplementedError):
        moe.moe_block(tp, torch.from_numpy(x), cfg, "swiglu", spec=name)


def test_sorted_dispatch_and_unknown_strategy_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        strategy.ExecutionSpec(strategy="capacity",
                               sorted_dispatch=True).validate()
    with pytest.raises(KeyError):
        strategy.get_strategy("nope")
    spec = strategy.ExecutionSpec.load(str(REPO / "examples" / "moe-spec.json"))
    with pytest.raises(NotImplementedError):
        spec.validate()
    assert strategy.available() == ("capacity", "dense")
    assert dataclasses.replace(spec, sorted_dispatch=None, strategy="dense",
                               prefill=None, decode=None,
                               layer_overrides=()).validate()

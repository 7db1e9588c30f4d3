"""The chiplet simulator: port vs JAX package, and its invariants.

The simulator is numpy only in both packages, so the port must give the
reference's results exactly (``==`` on every field of ``LayerResult``,
``ModeResult`` and ``E2EResult``, on ``util_series`` and on every
workload), over several seeds: an event loop over ``heapq`` with float
sums either repeats the reference step for step or is a fault.  The
invariants of ``tests/test_sim.py`` and ``tests/test_sim_properties.py``
(work conservation, exact DDR bytes, no deadlock, utilization bounds, no
D2D transfer before a slice's load) are then run on the port.
"""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.configs import reduced_config as jreduced
from repro.serving import traffic as jtraffic
from repro.sim import e2e as je2e
from repro.sim import engine as jengine
from repro.sim import hardware as jhw
from repro.sim import modes as jmodes
from repro.sim import workload as jworkload
from repro_torch import sim as port_sim
from repro_torch.configs import reduced_config
from repro_torch.serving import traffic
from repro_torch.sim import e2e, engine, hardware as hw, modes, workload

SEEDS = (0, 1, 2)
# a small spec (fast event loop) and one of the paper's (Table I)
SMALL = dict(name="prop", d_model=256, d_expert=512, num_experts=16,
             top_k=2)
STRATEGIES = ("ep", "hydra", "fse_dp_naive", "fse_dp", "fse_dp_paired",
              "fse_dp_rule5")


def _same(a, b):
    """Exact equality, field by field, of two results or workloads."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            _same(fa[k], fb[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


def _specs():
    return (hw.ModelSpec(**SMALL), jhw.ModelSpec(**SMALL))


# ---------------------------------------------------------------------------
# hardware and workloads
# ---------------------------------------------------------------------------


def test_hardware_matches_reference():
    assert port_sim.PROTOTYPE_2X2 == hw.PROTOTYPE_2X2
    _same(hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2)
    _same(hw.PROTOTYPE_2X2_NDP, jhw.PROTOTYPE_2X2_NDP)
    for rows, cols in ((1, 2), (2, 2), (2, 4), (4, 2), (3, 3), (4, 4)):
        _same(hw.scaled(rows, cols), jhw.scaled(rows, cols))
        _same(hw.with_ndp(hw.scaled(rows, cols)),
              jhw.with_ndp(jhw.scaled(rows, cols)))
        _same(hw.scaled(rows, cols, hw.PROTOTYPE_2X2_NDP),
              jhw.scaled(rows, cols, jhw.PROTOTYPE_2X2_NDP))
    for name, spec in hw.PAPER_SPECS.items():
        _same(spec, jhw.PAPER_SPECS[name])
        assert spec.expert_bytes == jhw.PAPER_SPECS[name].expert_bytes
        assert spec.expert_flops_per_token() == \
            jhw.PAPER_SPECS[name].expert_flops_per_token()
    wide = dataclasses.replace(hw.PROTOTYPE_2X2, bytes_per_param=4)
    jwide = dataclasses.replace(jhw.PROTOTYPE_2X2, bytes_per_param=4)
    cfg, jcfg = reduced_config("granite-moe-1b-a400m"), \
        jreduced("granite-moe-1b-a400m")
    for kw, jkw in (({}, {}), ({"hw": wide}, {"hw": jwide}),
                    ({"weight_bytes": 1}, {"weight_bytes": 1})):
        s, js = hw.spec_from_config(cfg, **kw), \
            jhw.spec_from_config(jcfg, **jkw)
        _same(s, js)
        assert s.expert_bytes_on(wide) == js.expert_bytes_on(jwide)


@pytest.mark.parametrize("seed", SEEDS)
def test_workloads_match_reference(seed):
    spec, jspec = _specs()
    for tokens in (16, 64, 256):
        _same(workload.make_requests(tokens, 4, seed),
              jworkload.make_requests(tokens, 4, seed))
        _same(workload.iteration_workloads(spec, tokens, 4, seed),
              jworkload.iteration_workloads(jspec, tokens, 4, seed))
    reqs = workload.make_requests(48, 4, seed)
    for layer in (0, 3):
        _same(workload.make_layer_workload(spec, reqs, 4, layer, seed,
                                           mix=0.3),
              jworkload.make_layer_workload(
                  jspec, jworkload.make_requests(48, 4, seed), 4, layer,
                  seed, mix=0.3))
    p = workload.sample_expert_probs(16, np.random.default_rng(seed), 1.3)
    _same(p, jworkload.sample_expert_probs(16, np.random.default_rng(seed),
                                           1.3))
    _same(workload.route_tokens(16, 2, 20, p, np.random.default_rng(seed)),
          jworkload.route_tokens(16, 2, 20, p, np.random.default_rng(seed)))
    rng = np.random.default_rng(seed)
    trace = []
    for it in range(3):
        for layer in (0, 2):
            trace.append({"iter": it, "layer": layer,
                          "counts": rng.integers(0, 9, 16)})
        trace.append({"iter": it, "event": "preempt", "rid": "r0"})
    for P in (1, 4, 8):
        _same(workload.workloads_from_trace(trace, P),
              jworkload.workloads_from_trace(trace, P))
        for rec in trace[:2]:
            wl = workload.workload_from_counts(rec["counts"], P, {"a": [1]})
            _same(wl, jworkload.workload_from_counts(rec["counts"], P,
                                                     {"a": [1]}))
            np.testing.assert_array_equal(wl.expert_totals, rec["counts"])
    _same(workload.trace_expert_totals(trace),
          jworkload.trace_expert_totals(trace))


def test_to_sim_requests_matches_reference():
    kw = dict(num_requests=6, rate=0.8, avg_prompt=8, max_prompt=16,
              min_new=2, max_new=4, vocab=97, seed=3,
              mix="poisson+zipf_prefix")
    got = traffic.to_sim_requests(traffic.make_traffic(
        traffic.TrafficConfig(**kw)))
    want = jtraffic.to_sim_requests(jtraffic.make_traffic(
        jtraffic.TrafficConfig(**kw)))
    _same(got, want)


# ---------------------------------------------------------------------------
# the discrete-event layer simulator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_layer_matches_reference(strategy, seed):
    spec, jspec = _specs()
    for hwc, jhwc, tokens in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2, 48),
                              (hw.scaled(2, 4), jhw.scaled(2, 4), 96)):
        wl = workload.iteration_workloads(spec, tokens, hwc.num_chiplets,
                                          seed)[0]
        jwl = jworkload.iteration_workloads(jspec, tokens,
                                            jhwc.num_chiplets, seed)[0]
        kw = {} if strategy == "fse_dp_naive" else {"record_timeline": True}
        got = engine.simulate_layer(hwc, spec, wl, strategy, **kw)
        want = jengine.simulate_layer(jhwc, jspec, jwl, strategy, **kw)
        _same(got, want)
        assert got.util_curve == want.util_curve
        for bins in (8, 32):
            _same(got.util_series(bins), want.util_series(bins))


@pytest.mark.parametrize("seed", SEEDS)
def test_chiplet_sim_paper_spec_matches_reference(seed):
    """A Table-I model (qwen3-a3b, 128 experts top-8) through ChipletSim
    with each expert order, a micro-slice count and an in-flight bound
    the front door does not set, and through the naive A1 schedule."""
    spec, jspec = hw.PAPER_SPECS["qwen3-a3b"], jhw.PAPER_SPECS["qwen3-a3b"]
    wl = workload.iteration_workloads(spec, 64, 4, seed)[0]
    jwl = jworkload.iteration_workloads(jspec, 64, 4, seed)[0]
    for order in ("natural", "sorted", "paired"):
        kw = dict(strategy="fse_dp", micro_slices=4, order=order,
                  max_inflight_experts=3)
        _same(engine.ChipletSim(hw.PROTOTYPE_2X2, spec, wl, **kw).run(),
              jengine.ChipletSim(jhw.PROTOTYPE_2X2, jspec, jwl, **kw).run())
    _same(engine.simulate_naive_fsedp(hw.PROTOTYPE_2X2, spec, wl),
          jengine.simulate_naive_fsedp(jhw.PROTOTYPE_2X2, jspec, jwl))


# ---------------------------------------------------------------------------
# step-level modes, EP, the two tiers, the trajectory flow and the referee
# ---------------------------------------------------------------------------


def _loads(E, seed):
    return workload.sample_expert_probs(E, np.random.default_rng(seed), 1.2)


@pytest.mark.parametrize("seed", SEEDS)
def test_modes_match_reference(seed):
    spec, jspec = _specs()
    for hwc, jhwc in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                      (hw.scaled(2, 4), jhw.scaled(2, 4)),
                      (hw.scaled(1, 2), jhw.scaled(1, 2))):
        for loads in (None, _loads(16, seed)):
            for tokens in (1, 8, 128):
                for mode in ("stream", "index", "slice"):
                    for M in (1, 4):
                        kw = dict(micro_slices=M, loads=loads,
                                  capacity_factor=1.5, act_bytes=4)
                        _same(modes.simulate_mode(hwc, spec, mode, tokens,
                                                  **kw),
                              jmodes.simulate_mode(jhwc, jspec, mode, tokens,
                                                   **kw))
                _same(modes.simulate_ep(hwc, spec, tokens, loads=loads),
                      jmodes.simulate_ep(jhwc, jspec, tokens, loads=loads))
    with pytest.raises(ValueError):
        modes.simulate_mode(hw.PROTOTYPE_2X2, spec, "bogus", 4)
    with pytest.raises(ValueError):
        modes.simulate_ep(hw.scaled(1, 3), spec, 4)


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_hybrid_matches_reference(seed):
    spec, jspec = _specs()
    for base, jbase in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                        (hw.scaled(2, 4), jhw.scaled(2, 4))):
        hwc, jhwc = hw.with_ndp(base), jhw.with_ndp(jbase)
        loads = _loads(16, seed)
        for tokens in (1, 4, 64):
            for ld in (None, loads):
                _same(modes.simulate_hybrid(hwc, spec, tokens, loads=ld),
                      jmodes.simulate_hybrid(jhwc, jspec, tokens, loads=ld))
                for hot in (range(4), np.argsort(-loads)[:5], []):
                    _same(modes.simulate_hybrid(hwc, spec, tokens, loads=ld,
                                                hot_ids=hot),
                          jmodes.simulate_hybrid(jhwc, jspec, tokens,
                                                 loads=ld, hot_ids=hot))
    with pytest.raises(ValueError, match="near-memory"):
        modes.simulate_hybrid(hw.PROTOTYPE_2X2, spec, 8)


@pytest.mark.parametrize("seed", SEEDS)
def test_trajectory_and_replay_match_reference(seed):
    spec, jspec = _specs()
    rng = np.random.default_rng(seed)
    E = spec.num_experts
    trace = []
    for it in range(4):
        for layer in range(2):
            counts = rng.integers(0, 7, E) * (rng.random(E) < 0.6)
            rec = {"iter": it, "layer": layer, "counts": counts,
                   "schedule": ("dynamic", "static")[(it + layer) % 2],
                   "order": [int(e) for e in np.argsort(-counts)]}
            if it % 2:
                rec["trajectory"] = rec["order"][::-1]
            if layer:
                rec["resident"] = [int(e) for e in rng.permutation(E)[:3]]
            if it >= 2:
                rec["hot"] = [int(e) for e in rng.permutation(E)[:4]]
            trace.append(rec)
        trace.append({"iter": it, "event": "cache_hit", "rid": "r1"})
    trace.append({"iter": 9, "layer": 0, "counts": np.zeros(E),
                  "schedule": "static", "order": list(range(E))})
    for hwc, jhwc in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                      (hw.PROTOTYPE_2X2_NDP, jhw.PROTOTYPE_2X2_NDP)):
        for cf in (1.25, float(E)):
            assert modes.replay_trace(hwc, spec, trace, capacity_factor=cf) \
                == jmodes.replay_trace(jhwc, jspec, trace,
                                       capacity_factor=cf)
        for rec in trace[:-1]:
            if "counts" not in rec:
                continue
            c = rec["counts"]
            for kw in (dict(padded=True), dict(order=rec["order"]),
                       dict(order=rec["order"], resident=rec.get("resident")),
                       dict(padded=True, resident=[0, 1]), {}):
                assert modes.simulate_trajectory(hwc, spec, c, **kw) == \
                    jmodes.simulate_trajectory(jhwc, jspec, c, **kw)
            assert modes.schedule_step_times(hwc, spec, c) == \
                jmodes.schedule_step_times(jhwc, jspec, c)


def test_rank_matches_reference():
    spec, jspec = _specs()
    for hwc, jhwc in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                      (hw.with_ndp(hw.scaled(2, 4)),
                       jhw.with_ndp(jhw.scaled(2, 4)))):
        for B, S in ((1, 1), (8, 1), (4, 16), (1, 128), (2, 3)):
            assert modes.rank_modes(hwc, spec, B * S, B=B, S=S) == \
                jmodes.rank_modes(jhwc, jspec, B * S, B=B, S=S)
            assert modes.rank_modes(hwc, spec, B * S, B=B, S=S,
                                    micro_slices=2) == \
                jmodes.rank_modes(jhwc, jspec, B * S, B=B, S=S,
                                  micro_slices=2)
            for loads in (None, _loads(16, B)):
                assert modes.rank_families(hwc, spec, B * S, B=B, S=S,
                                           loads=loads) == \
                    jmodes.rank_families(jhwc, jspec, B * S, B=B, S=S,
                                         loads=loads)


@pytest.mark.parametrize("strategy,slack,sample", [
    ("fse_dp_paired", 0.0, None), ("ep", 0.0, 2), ("fse_dp", 0.3, None)])
def test_run_e2e_matches_reference(strategy, slack, sample):
    spec = dataclasses.replace(hw.ModelSpec(**SMALL), num_layers=4)
    jspec = dataclasses.replace(jhw.ModelSpec(**SMALL), num_layers=4)
    kw = dict(strategy=strategy, tokens_per_iter=32, iterations=3, seed=1,
              buffering_slack=slack, theta_min=3, layer_sample=sample,
              ctx=256)
    got = e2e.run_e2e(hw.PROTOTYPE_2X2, spec, **kw)
    _same(got, je2e.run_e2e(jhw.PROTOTYPE_2X2, jspec, **kw))
    assert got.tokens_processed > 0 and got.total_time > 0
    if slack:
        assert got.deferral_events > 0


# ---------------------------------------------------------------------------
# invariants, on the port (tests/test_sim.py, tests/test_sim_properties.py)
# ---------------------------------------------------------------------------

HW = hw.PROTOTYPE_2X2
QWEN = hw.PAPER_SPECS["qwen3-a3b"]


def _wl(tokens=64, seed=0, spec=QWEN):
    return workload.iteration_workloads(spec, tokens, HW.num_chiplets,
                                        seed)[0]


def test_work_and_bytes_conserved():
    """Busy compute time is the exact per-(chip, expert) work; every active
    expert's weights cross DDR once; EP moves no weights over D2D; FSE-DP
    moves each micro-slice |trajectory| - 1 hops."""
    wl = _wl()
    r = engine.simulate_layer(HW, QWEN, wl, "fse_dp_paired")
    np.testing.assert_allclose(
        r.busy_time.sum(),
        wl.counts.sum() * QWEN.expert_flops_per_token() / HW.tops, rtol=1e-6)
    active = int((wl.expert_totals > 0).sum())
    for strat in ("fse_dp", "fse_dp_paired", "ep", "hydra"):
        r = engine.simulate_layer(HW, QWEN, wl, strat)
        np.testing.assert_allclose(r.ddr_bytes, active * QWEN.expert_bytes,
                                   rtol=1e-9, err_msg=strat)
    assert engine.simulate_layer(HW, QWEN, wl, "ep").d2d_bytes == 0.0
    hops = sum(QWEN.expert_bytes * (int((wl.counts[:, e] > 0).sum()) - 1)
               for e in range(QWEN.num_experts) if wl.expert_totals[e])
    np.testing.assert_allclose(
        engine.simulate_layer(HW, QWEN, wl, "fse_dp").d2d_bytes, hops,
        rtol=1e-6)
    sim = engine.ChipletSim(HW, QWEN, wl, strategy="fse_dp")
    for e in range(QWEN.num_experts):
        assert sim._trajectory(e) == [c for c in range(HW.num_chiplets)
                                      if wl.counts[c, e] > 0]


def test_paper_orderings_hold():
    """Fig. 12 (FSE-DP memory under half of EP's), Fig. 9 (FSE-DP faster
    than EP at 64 tokens), Fig. 15 (A2 beats the naive A1) and Fig. 18
    (FSE-DP's utilization degrades less from 2x2 to 4x4)."""
    for name, spec in hw.PAPER_SPECS.items():
        wl = _wl(spec=spec)
        fse = engine.simulate_layer(HW, spec, wl, "fse_dp_paired")
        ep = engine.simulate_layer(HW, spec, wl, "ep")
        assert fse.peak_buffer_bytes < ep.peak_buffer_bytes / 2.0, name
        assert ep.latency / fse.latency > 1.0, name
    wl = _wl(tokens=256)
    assert engine.simulate_layer(HW, QWEN, wl, "fse_dp").latency < \
        engine.simulate_layer(HW, QWEN, wl, "fse_dp_naive").latency
    util = {}
    for strat in ("ep", "fse_dp_paired"):
        us = {}
        for rows in (2, 4):
            hwc = hw.scaled(rows, rows)
            w = workload.iteration_workloads(QWEN, 256, hwc.num_chiplets,
                                             0)[0]
            us[rows] = engine.simulate_layer(hwc, QWEN, w, strat).utilization
        util[strat] = us[4] / max(us[2], 1e-9)
    assert util["fse_dp_paired"] > util["ep"]


SMALL_SPEC = hw.ModelSpec(**SMALL)


def _check_invariants(seed, strategy="fse_dp_paired"):
    reqs = workload.make_requests(48, HW.num_chiplets, seed)
    wl = workload.make_layer_workload(SMALL_SPEC, reqs, HW.num_chiplets, 0,
                                      seed)
    res = engine.simulate_layer(HW, SMALL_SPEC, wl, strategy,
                                record_timeline=True)
    assert 0.0 <= res.utilization <= 1.0 + 1e-9
    series = res.util_series(bins=16)
    assert np.all(series >= -1e-9) and np.all(series <= 1.0 + 1e-9)
    assert res.latency > 0.0 and np.isfinite(res.latency)
    expected = wl.counts.astype(np.float64) \
        * SMALL_SPEC.expert_flops_per_token() / HW.tops
    np.testing.assert_allclose(res.busy_time, expected.sum(axis=1),
                               rtol=1e-9, atol=1e-15)
    assert not res.dropped_experts
    loads, starts = {}, {}
    for t, _chip, kind, dur in res.timeline:
        uid = int(str(kind).rsplit(":u", 1)[1])
        if str(kind).startswith("load:"):
            loads[uid] = t + dur
        else:
            starts.setdefault(uid, []).append(t)
    assert loads
    for uid, done in loads.items():
        assert all(t >= done - 1e-12 for t in starts.get(uid, ()))
    assert abs(float(res.util_series(bins=64).mean())
               - res.utilization) < 1e-6


@pytest.mark.parametrize("seed,strategy", [
    (0, "fse_dp_paired"), (1, "fse_dp_paired"), (2, "fse_dp_paired"),
    (3, "fse_dp_paired"), (0, "fse_dp"), (0, "fse_dp_rule5")])
def test_invariants(seed, strategy):
    """Micro-slice conservation, no D2D or compute before a slice's load,
    utilization (and its binned curve) within [0, 1]."""
    _check_invariants(seed, strategy)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([16, 64, 256]))
def test_no_deadlock_property(seed, tokens):
    wl = workload.iteration_workloads(QWEN, tokens, HW.num_chiplets,
                                      seed)[0]
    assert np.isfinite(engine.simulate_layer(HW, QWEN, wl,
                                             "fse_dp_paired").latency)
    _check_invariants(seed)


def test_whole_expert_strategies_bounded():
    """EP / hydra share the event engine: utilization bounded, and EP's
    busy time at least the owner-resident compute (owner of e is e % P)."""
    reqs = workload.make_requests(48, HW.num_chiplets, 1)
    wl = workload.make_layer_workload(SMALL_SPEC, reqs, HW.num_chiplets, 0, 1)
    for strategy in ("ep", "hydra"):
        res = engine.simulate_layer(HW, SMALL_SPEC, wl, strategy)
        assert 0.0 <= res.utilization <= 1.0 + 1e-9 and res.latency > 0
    P = HW.num_chiplets
    res = engine.simulate_layer(HW, SMALL_SPEC, wl, "ep")
    owner = np.array([wl.counts[e % P, e]
                      for e in range(SMALL_SPEC.num_experts)], np.float64)
    assert res.busy_time.sum() >= owner.sum() \
        * SMALL_SPEC.expert_flops_per_token() / HW.tops - 1e-12

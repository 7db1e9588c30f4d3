"""The state pool's prefix cache and preemption, and the engine knobs that
ride on them: port vs JAX on the CPU.

The port's ``StatePool`` and the reference's, driven by one sequence of
calls, hand out the same page ids, copy plans, refcounts, tables and
counters; ``hash_chain`` gives the same bytes.  On reduced granite in fp32
(the reference test's sizes: max_batch 2, max_ctx 24, 4-token chunks),
the port's engine, fused and eager, gives the reference's tokens and pool
counters for a cache hit, for preemption and for both together, at
temperature 0.7 and with ``drop_free=False``; a cache hit or a preemption
changes no token.  The reference runs its fused engine with
``use_kernels(False)``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.serving import Engine as JEngine
from repro.serving import Scheduler as JScheduler
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServeConfig as JServeConfig
from repro.serving import TrafficConfig as JTrafficConfig
from repro.serving import make_traffic as jmake_traffic
from repro.serving import run_closed_loop as jrun_closed_loop
from repro.serving import statepool as jstatepool
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import transformer
from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                 ServeConfig, TrafficConfig, make_traffic,
                                 run_closed_loop, statepool)

REPO = Path(__file__).resolve().parent.parent
ARCH = "granite-moe-1b-a400m"
POOL_COUNTERS = ("pool_pages", "pool_pages_in_use", "pool_peak_pages",
                 "cache_hits", "cache_misses", "cache_evictions",
                 "prefill_tokens_saved", "preemptions", "restores")
PROMPT = [5, 6, 7, 8, 9, 10, 11]
# the reference test's closed loop: 8 requests with 2 Zipf-shared 6-token
# system prompts through 2 slots
TRAFFIC = dict(num_requests=8, rate=2.0, avg_prompt=8, max_prompt=16,
               min_new=2, max_new=4, seed=0, mix="poisson+zipf_prefix",
               num_prefixes=2, prefix_len=6)
LOOPS = {"unbounded": (False, None), "preempt": (False, 0),
         "preempt+cache": (True, 0)}


# ---------------------------------------------------------------------------
# the pool alone (host metadata, no model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens", [[1, 2, 3, 4], [1, 2, 9, 4], [0],
                                    [-3, 2 ** 40, 49154, 7] * 5])
def test_hash_chain_matches_reference(tokens):
    assert statepool.hash_chain(tokens) == jstatepool.hash_chain(tokens)
    assert statepool.hash_chain(np.asarray(tokens)) == \
        jstatepool.hash_chain(tokens)


def _pool_state(pool):
    return (pool.table.tolist(), list(pool.free), pool.ref.tolist(),
            [list(r) for r in pool.slot_pages],
            [(e.key, e.length, list(e.page_ids), e.hits)
             for e in pool.entries.values()],
            {k: pool.stats[k] for k in POOL_COUNTERS if k in pool.stats})


def _drive(mod, log):
    """One sequence of pool calls; every result and the state after each
    call go to ``log``."""
    pool = mod.StatePool(max_batch=3, max_ctx=16, page_size=4, num_pages=14,
                         max_prefix_entries=3, bytes_per_page=10)
    keys = [mod.hash_chain(list(range(s, s + 12))) for s in (1, 40, 80, 120)]
    handles = []

    def call(name, fn):
        try:
            out = fn()
        except mod.PoolExhausted:
            out = "PoolExhausted"
        if isinstance(out, mod.PrefixEntry):
            out = (out.key, out.length, list(out.page_ids), out.hits)
        if isinstance(out, mod.PreemptedState):
            out = list(out.page_ids)
        log.append((name, out, _pool_state(pool)))

    call("ensure", lambda: pool.ensure(0, 6))
    call("register tail", lambda: pool.register_prefix(keys[0][5], 6, 0))
    call("register again", lambda: pool.register_prefix(keys[0][5], 6, 0))
    call("ensure", lambda: pool.ensure(0, 12))
    call("register full", lambda: pool.register_prefix(keys[0][7], 8, 0))
    call("lookup", lambda: pool.lookup_prefix(keys[0], 11))
    call("lookup capped", lambda: pool.lookup_prefix(keys[0], 7))
    call("lookup miss", lambda: pool.lookup_prefix(keys[1], 11))
    call("attach", lambda: pool.attach_prefix(pool.lookup_prefix(keys[0], 7), 1))
    call("ensure", lambda: pool.ensure(1, 9))
    call("release", lambda: pool.release_slot(0))
    call("ensure", lambda: pool.ensure(0, 16))
    for i in (1, 2, 3):                       # past 3 entries: LRU eviction
        call(f"register {i}", lambda i=i: pool.register_prefix(keys[i][3], 4, 0))
    call("detach", lambda: handles.append(mod.PreemptedState(
        request=None, page_ids=pool.detach_slot(0), cache_len=16)))
    call("ensure", lambda: pool.ensure(2, 16))
    call("ensure", lambda: pool.ensure(0, 16))   # evicts entries on demand
    call("exhausted", lambda: pool.ensure(0, 16))
    call("release", lambda: pool.release_slot(0))
    call("attach pages", lambda: pool.attach_pages(0, handles[0].page_ids))
    call("release", lambda: pool.release_slot(0))
    call("detach", lambda: handles.append(mod.PreemptedState(
        request=None, page_ids=pool.detach_slot(1), cache_len=9)))
    call("drop handle", lambda: pool.drop_handle(handles[1]))
    return pool


def test_pool_matches_reference_call_for_call():
    got, want = [], []
    pool = _drive(statepool, got)
    _drive(jstatepool, want)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    outcomes = {name: out for name, out, _ in got}
    assert outcomes["exhausted"] == "PoolExhausted"
    assert pool.stats["cache_evictions"] >= 2
    assert pool.stats["cache_hits"] == 1
    # the device pool's sink page (index num_pages) is never handed out,
    # referenced, put in a table row or held by an entry
    for _, _, (table, free, ref, rows, entries, _) in got:
        assert len(ref) == pool.num_pages
        assert max(free + [p for r in rows for p in r]
                   + [p for e in entries for p in e[2]]) < pool.num_pages
        assert np.asarray(table).max() < pool.num_pages


def test_copy_page_matches_reference():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jc = jtf.init_paged_caches(jcfg, 2, 6, 4)
    rng = np.random.default_rng(0)
    jc = jax.tree.map(lambda a: jax.numpy.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jc)
    caches = transformer.init_paged_caches(cfg, 2, 6, 4, "cpu")
    for c, j in zip(caches, jc):
        for pages, jpages in zip(c.kv, j.kv):
            pages[:, :-1] = bridge.to_tensor(jpages, "cpu")
    sink = [pages[:, -1].clone() for c in caches for pages in c.kv]
    statepool.copy_page(caches, 4, 1)
    jc = jstatepool.copy_page(jc, 4, 1)
    for c, j in zip(caches, jc):
        for pages, jpages in zip(c.kv, j.kv):
            assert torch.equal(pages[:, :-1], bridge.to_tensor(jpages, "cpu"))
    assert all(torch.equal(s, pages[:, -1]) for s, pages in
               zip(sink, (p for c in caches for p in c.kv)))


# ---------------------------------------------------------------------------
# the engine (reduced granite, fp32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _kw(**kw):
    return dict(max_batch=2, max_ctx=24, chunk_tokens=4, **kw)


def _serve_twice(make, prompt, **kw):
    """The same prompt twice, one after the other, on one engine."""
    eng = make(**kw)
    outs = []
    for _ in range(2):
        rid = eng.submit_chunked(list(prompt), max_new=4)
        outs.append(eng.run()[rid])
    return eng, outs


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's runs, once for the module: the cache hit, the three
    closed loops, temperature sampling and finite capacity."""
    jcfg, cfg, jparams, _ = weights

    def make(**kw):
        return JEngine(jparams, jcfg, JServeConfig(**_kw(**kw)))

    out = {}
    with jops.use_kernels(False):
        out["hit"] = _serve_twice(make, PROMPT, prefix_cache=True)
        traffic = jmake_traffic(JTrafficConfig(vocab=cfg.vocab_size,
                                               **TRAFFIC))
        for name, (cache, depth) in LOOPS.items():
            sched = JScheduler(make(prefix_cache=cache,
                                    preempt_queue_depth=depth),
                               JSchedulerConfig(queue_capacity=64))
            out[name] = (sched.engine, jrun_closed_loop(sched, traffic))
        out["temperature"] = _serve_twice(make, PROMPT, temperature=0.7,
                                          seed=3)
        out["finite"] = _serve_twice(make, PROMPT, drop_free=False)
    return out


def _engine(weights, fused, **kw):
    _, cfg, _, params = weights
    return Engine(params, cfg, ServeConfig(**_kw(fused=fused, **kw)),
                  device="cpu")


def _counters(stats):
    return {k: stats[k] for k in POOL_COUNTERS}


FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "eager"])


@FUSED
def test_prefix_cache_hit_matches_reference(weights, reference, fused):
    jeng, want = reference["hit"]
    cold, outs_cold = _serve_twice(
        lambda **kw: _engine(weights, fused, **kw), PROMPT)
    eng, outs = _serve_twice(lambda **kw: _engine(weights, fused, **kw),
                             PROMPT, prefix_cache=True)
    assert outs == outs_cold == want
    assert (eng.stats["cache_hits"], eng.stats["cache_misses"],
            eng.stats["prefill_tokens_saved"]) == (1, 1, 4)
    assert _counters(eng.stats) == _counters(jeng.stats)
    assert eng.stats["prefill_tokens"] == cold.stats["prefill_tokens"] - 4
    hits = [r for r in eng.trace if r.get("event") == "cache_hit"]
    assert hits == [r for r in jeng.trace if r.get("event") == "cache_hit"]
    assert len(hits) == 1 and hits[0]["cached_tokens"] == 4


@FUSED
def test_closed_loop_preempt_and_cache_match_reference(weights, reference,
                                                      fused):
    """Preemption, then preemption with the prefix cache, give the
    unbounded run's tokens; each run's tokens, metrics and events are the
    reference's."""
    _, cfg, _, _ = weights
    traffic = make_traffic(TrafficConfig(vocab=cfg.vocab_size, **TRAFFIC))
    got = {}
    for name, (cache, depth) in LOOPS.items():
        sched = Scheduler(_engine(weights, fused, prefix_cache=cache,
                                  preempt_queue_depth=depth),
                          SchedulerConfig(queue_capacity=64))
        got[name] = (sched.engine, run_closed_loop(sched, traffic))
    for name, (eng, res) in got.items():
        jeng, want = reference[name]
        assert res["outputs"] == got["unbounded"][1]["outputs"], name
        assert res["outputs"] == want["outputs"], name
        assert res["metrics"].completed == 8 and not res["dropped"]
        gm, wm = res["metrics"].to_dict(), want["metrics"].to_dict()
        assert gm == {k: wm[k] for k in gm}, name
        assert _counters(eng.stats) == _counters(jeng.stats), name
        events = [r for r in eng.trace if "event" in r]
        assert events == [r for r in jeng.trace if "event" in r], name
    m = got["preempt"][1]["metrics"]
    assert m.preemptions > 0 and m.restores == m.preemptions
    m = got["preempt+cache"][1]["metrics"]
    assert m.preemptions > 0 and m.cache_hits > 0
    assert got["preempt+cache"][0].stats["prefill_tokens"] < \
        got["unbounded"][0].stats["prefill_tokens"]


def _kv_pages(eng, ids):
    return [pages[:, ids].clone() for c in eng.caches for pages in c.kv]


@FUSED
def test_preempted_pages_untouched_while_slot_reused(weights, fused):
    """While a handle holds a preempted request's pages, its old slot is
    idle (masked writes go to the sink page), then taken by another
    request, whose writes land in its own pages although the slot's table
    row still names the handle's beyond them; the restored request then
    gives the tokens of a run never preempted."""
    prompts = ([3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8],
               [1, 6, 1, 8, 0, 3, 3, 9, 8, 8, 7])
    base = _engine(weights, fused)
    rids = [base.submit_chunked(list(p), max_new=6) for p in prompts[:2]]
    want = base.run()
    eng = _engine(weights, fused)
    a, b = (eng.submit_chunked(list(p), max_new=6) for p in prompts[:2])
    for _ in range(4):
        eng.step()
    slot = eng.requests[a].slot
    handle = eng.preempt(a)
    held = _kv_pages(eng, handle.page_ids)
    assert eng.pool.table[slot, :len(handle.page_ids)].tolist() == \
        handle.page_ids
    eng.step()                                # the slot idles
    c = eng.submit_chunked(list(prompts[2]), max_new=3)
    assert eng.requests[c].slot == slot
    for _ in range(3):
        eng.step()                            # it is reused
    after = _kv_pages(eng, handle.page_ids)
    assert all(torch.equal(x, y) for x, y in zip(held, after))
    eng.run()
    eng.restore(handle)
    outs = eng.run()
    assert [outs[a], outs[b]] == [want[r] for r in rids]
    assert (eng.stats["preemptions"], eng.stats["restores"]) == (1, 1)


def test_preempt_refuses_mid_pass(weights):
    eng = _engine(weights, True)
    rid = eng.submit_chunked([1, 2, 3, 4, 5], max_new=4)
    eng.step()
    eng.step()
    eng.requests[rid].progress = 3            # deferred at a boundary
    with pytest.raises(ValueError, match="mid-pass"):
        eng.preempt(rid)
    with pytest.raises(ValueError, match="no active request"):
        eng.preempt("req99")
    assert eng.stats["preemptions"] == 0 and rid in eng.requests
    with pytest.raises(ValueError, match="preempt_queue_depth"):
        ServeConfig(preempt_queue_depth=-1)


def test_sample_draws_the_reference_tokens(weights):
    """Given the same fp32 logits and seed, the port's sampler draws the
    reference's tokens, greedy and at temperature."""
    jcfg, cfg, jparams, params = weights
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, cfg.vocab_size)).astype(np.float32) * 3
    for temp in (0.0, 0.7, 1.5):
        eng = Engine(params, cfg, ServeConfig(**_kw(temperature=temp,
                                                    seed=3)), device="cpu")
        jeng = JEngine(jparams, jcfg, JServeConfig(**_kw(temperature=temp,
                                                         seed=3)))
        got = [eng._sample(lf) for lf in logits]
        assert got == [jeng._sample(lf) for lf in logits]
        assert temp == 0.0 or len(set(got)) > 1


@FUSED
def test_temperature_tokens_match_reference(weights, reference, fused):
    _, want = reference["temperature"]
    _, outs = _serve_twice(lambda **kw: _engine(weights, fused, **kw),
                           PROMPT, temperature=0.7, seed=3)
    assert outs == want


@FUSED
def test_drop_free_false_keeps_capacity_factor(weights, reference, fused):
    jeng, want = reference["finite"]
    _, cfg, _, _ = weights
    eng, outs = _serve_twice(lambda **kw: _engine(weights, fused, **kw),
                             PROMPT, drop_free=False)
    assert eng.cfg.moe.capacity_factor == cfg.moe.capacity_factor \
        == jeng.cfg.moe.capacity_factor < cfg.moe.num_experts
    assert _engine(weights, fused).cfg.moe.capacity_factor == \
        float(cfg.moe.num_experts)
    assert outs == want


def test_serve_cli_prefix_cache_and_preemption():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--traffic", "--dry-run",
         "--prefix-cache", "--preempt-depth", "0", "--max-batch", "2",
         "--traffic-requests", "6", "--traffic-mix", "poisson+zipf_prefix"],
        env=env, timeout=300, capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "traffic: 6 completed, 0 dropped" in out.stdout, out.stdout
    assert "3 cache hits / 3 misses (24 prefill tokens saved), " \
        "2 preemptions / 2 restores" in out.stdout, out.stdout
    assert "traffic dry-run OK" in out.stdout

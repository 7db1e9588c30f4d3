"""The port's fused segments on the CPU (no graphs there; the segment
functions run directly): bit for bit the eager per-layer loop, the
reference's sync budget, and one route per MoE boundary per iteration.

Fused and eager run the same ``transformer.decode_*`` calls, so tokens,
every trace record (counts, orders, trajectories, phase, modeled
seconds) and the engine statistics must be identical, not close.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import gating
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import moe
from repro_torch.serving import Engine, ServeConfig

ARCH = "granite-moe-1b-a400m"
PROMPTS = ((1, 2, 3, 4), (9, 8, 7), (5, 5, 6, 7, 8, 9, 10), (11, 12))
STATS = ("deferrals", "dynamic_schedules", "tokens_emitted", "iterations",
         "expert_loads", "expert_loads_saved", "prefill_chunks",
         "prefill_tokens")


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(ARCH).replace(dtype="float32")
    return cfg, api.init_params(cfg, seed=0, device="cpu")


def _run(cfg, params, *, fused, chunked, schedule, slack=0.0,
         sorted_dispatch=None):
    spec = {"strategy": "capacity"}
    if schedule:
        spec["schedule"] = schedule
    if sorted_dispatch is not None:
        spec["sorted_dispatch"] = sorted_dispatch
    eng = Engine(params, cfg, ServeConfig(
        max_batch=4, max_ctx=48, fused=fused, chunk_tokens=3,
        buffering_slack=slack, theta_min=3, page_size=4, spec=spec),
        device="cpu")
    sub = eng.submit_chunked if chunked else eng.submit
    rids = [sub(list(p), max_new=8) for p in PROMPTS]
    outs = eng.run()
    return eng, [outs[r] for r in rids]


def _assert_same(e0, o0, e1, o1):
    assert o0 == o1
    assert len(e0.trace) == len(e1.trace)
    for a, b in zip(e0.trace, e1.trace):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
    for k in STATS:
        assert e0.stats[k] == e1.stats[k], k


@pytest.mark.parametrize("slack", [0.0, 0.2])
@pytest.mark.parametrize("schedule", [None, "dynamic"],
                         ids=["static", "dynamic"])
@pytest.mark.parametrize("chunked", [False, True], ids=["submit", "chunked"])
def test_fused_matches_eager(setup, chunked, schedule, slack):
    cfg, params = setup
    e0, o0 = _run(cfg, params, fused=False, chunked=chunked,
                  schedule=schedule, slack=slack)
    e1, o1 = _run(cfg, params, fused=True, chunked=chunked,
                  schedule=schedule, slack=slack)
    _assert_same(e0, o0, e1, o1)
    assert all("modeled_s" in r for r in e1.trace)
    if slack:
        assert e1.stats["deferrals"] > 0
    if chunked:
        assert e1.stats["prefill_chunks"] > 0
        assert {r["phase"] for r in e1.trace} == {"prefill", "decode"}
    assert e0.stats["host_syncs"] == 0 < e1.stats["host_syncs"]


def test_steady_state_sync_budget(setup):
    """One host sync per MoE boundary plus one logits fetch per steady
    decode iteration: 3 (nb + 1) over three."""
    cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(max_batch=4, max_ctx=48),
                 device="cpu")
    for p in PROMPTS:
        eng.submit(list(p), max_new=12)
    eng.step()
    eng.step()
    nb = len(eng.megastep().boundaries)
    assert nb == cfg.num_layers
    s0 = eng.stats["host_syncs"]
    for _ in range(3):
        eng.step()
    assert eng.stats["host_syncs"] - s0 == 3 * (nb + 1)


def test_fused_routes_each_moe_layer_once(setup, monkeypatch):
    """One decode iteration calls ``gating.route`` once per boundary: the
    same routing drives deferral, the trace and the experts."""
    cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(max_batch=2, max_ctx=32),
                 device="cpu")
    eng.submit([1, 2, 3], max_new=4)         # admission prefill routes too
    calls = []
    real = gating.route

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(gating, "route", counting)
    eng.step()
    assert len(calls) == len(eng.megastep().boundaries)


def test_segments_keyed_on_capture_settings(setup):
    """Segments captured with kernels on are never run with them off."""
    cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(max_batch=2, max_ctx=32),
                 device="cpu")
    ms = eng.megastep()
    assert eng.megastep() is ms
    with ops.use_kernels(False):
        assert eng.megastep() is not ms
    assert eng.megastep() is ms
    # a graph captured under one-hot dispatch never replays under an
    # ambient use_sorted_dispatch(True)
    with moe.use_sorted_dispatch(True):
        sorted_ms = eng.megastep()
        assert sorted_ms is not ms
    assert eng.megastep() is ms


@pytest.mark.parametrize("slack", [0.0, 0.2])
@pytest.mark.parametrize("schedule", [None, "dynamic"],
                         ids=["static", "dynamic"])
def test_fused_matches_eager_sorted_dispatch(setup, schedule, slack):
    """Sorted dispatch through the spec: the fused segments give the eager
    loop's tokens, trace and stats, and the one-hot run's tokens (drop-free
    capacity, fp32: the two dispatches move the same rows).  With kernels
    off, where the spec picks between the two (with kernels on both read
    the tables)."""
    cfg, params = setup
    with ops.use_kernels(False):
        runs = [_run(cfg, params, fused=fused, chunked=True,
                     schedule=schedule, slack=slack, sorted_dispatch=True)
                for fused in (False, True)]
        _assert_same(*runs[0], *runs[1])
        _, one_hot = _run(cfg, params, fused=True, chunked=True,
                          schedule=schedule, slack=slack)
    assert runs[1][1] == one_hot


def test_fused_engine_on_cpu_makes_no_graph(setup):
    cfg, params = setup
    eng, _ = _run(cfg, params, fused=True, chunked=True, schedule=None)
    ms = eng.megastep()
    assert ms.captures == 0 and not ms.graphs and eng.graph_launches() == 0
    assert isinstance(ms.x, torch.Tensor) and ms.x is eng._x


@pytest.mark.parametrize("layout", ["moe_every_2", "no_moe"])
def test_fused_matches_eager_other_layouts(setup, layout):
    """Dense layers between boundaries (``decode_span`` inside a segment)
    and a model with no MoE layer at all (the ``only`` segment)."""
    cfg, _ = setup
    cfg = cfg.replace(num_layers=4, moe_every=2) if layout == "moe_every_2" \
        else cfg.replace(moe=None)
    params = api.init_params(cfg, seed=1, device="cpu")
    runs = [_run(cfg, params, fused=fused, chunked=True, schedule=None)
            for fused in (False, True)]
    _assert_same(*runs[0], *runs[1])
    nb = len(runs[1][0].megastep().boundaries)
    assert nb == (2 if layout == "moe_every_2" else 0)

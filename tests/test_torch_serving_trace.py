"""The serving loop's host timers and spans on the CPU: reduced granite,
fp32, the fused engine under the scheduler.

``Engine.stats`` carries six integer counters of the host's time in an
iteration (``step_ns``, ``sync_wait_ns``, ``boundary_host_ns``,
``launch_ns``, ``prefill_pass_ns``, ``prefill_passes``), and while
``torch.profiler`` records, the host-only stretches are ``repro_torch.*``
spans (``repro_torch.tracing``).  Held here: the counters only grow and
nest as their intervals do; with the profiler off no ``record_function``
is entered, and tokens and trace records are the same with it on; under
the profiler each span lies inside the call that made it, encloses no
``aten::`` op (the host-only rule, as far as a CPU can show it: the
deferral's device count, the prefix cache's page copy and preemption run
outside the open span), and no span encloses another.
"""
import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType

from repro_torch.configs import reduced_config
from repro_torch.models import api
from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                 ServeConfig)

ARCH = "granite-moe-1b-a400m"
COUNTERS = ("step_ns", "sync_wait_ns", "boundary_host_ns", "launch_ns",
            "prefill_pass_ns", "prefill_passes")
SPANS = ("repro_torch.scheduler.admit", "repro_torch.engine.pages",
         "repro_torch.engine.boundary", "repro_torch.engine.finish",
         "repro_torch.engine.prefill_host")
# the prompts share a 7-token prefix, so the prefix cache hits with a
# partial tail page to copy (page_size 4)
SHARED = [3, 1, 4, 1, 5, 9, 2]
PROMPTS = [SHARED + [6, 5], [8, 9, 7, 9], SHARED + [3, 2, 3, 8],
           [4, 6, 2, 6, 4, 3, 3, 8, 3], SHARED + [7]]
SETTINGS = {
    "plain": dict(max_batch=4),
    # deferral (a device count of the rows kept at a boundary), the
    # prefix cache (a page copy at admission and at registration) and
    # preemption under a queue: device work amid the spans' host work
    "defer+prefix+preempt": dict(max_batch=2, buffering_slack=0.5,
                                 theta_min=2, prefix_cache=True,
                                 preempt_queue_depth=0,
                                 spec={"strategy": "capacity",
                                       "schedule": "dynamic"}),
}


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(ARCH).replace(dtype="float32")
    return cfg, api.init_params(cfg, seed=0, device="cpu")


def _serve(cfg, params, setting, on_step=None):
    """Every prompt through the scheduler over a fused engine -> (engine,
    each request's tokens)."""
    kw = dict(max_ctx=40, chunk_tokens=3, page_size=4)
    kw.update(SETTINGS[setting])
    eng = Engine(params, cfg, ServeConfig(**kw), device="cpu")
    assert eng.scfg.fused
    sched = Scheduler(eng, SchedulerConfig(queue_capacity=16))
    rids = [sched.offer(p, max_new=6) for p in PROMPTS]
    for _ in range(500):
        if not sched.pending():
            break
        before = dict(eng.stats)
        sched.step()
        if on_step is not None:
            on_step(before, eng.stats)
    assert not sched.pending()
    outs = sched.outputs()
    return eng, [outs[r] for r in rids]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_counters_grow_and_nest(setup, setting):
    cfg, params = setup
    chunk_steps = []

    def on_step(before, after):
        for k in COUNTERS:
            assert type(after[k]) is int, k
            assert after[k] >= before[k], k
        chunk_steps.append(after["prefill_chunks"] > before["prefill_chunks"])

    eng, _ = _serve(cfg, params, setting, on_step)
    s = eng.stats
    assert s["step_ns"] >= (s["sync_wait_ns"] + s["boundary_host_ns"]
                            + s["launch_ns"])
    assert s["boundary_host_ns"] > 0 and s["launch_ns"] > 0
    assert s["sync_wait_ns"] == 0           # the CPU queues nothing
    assert s["prefill_passes"] == sum(chunk_steps) > 0
    assert s["step_ns"] >= s["prefill_pass_ns"] > 0
    if setting != "plain":
        assert s["deferrals"] > 0 and s["cache_hits"] > 0 \
            and s["preemptions"] > 0


def test_eager_path_moves_only_step_ns(setup):
    cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(max_batch=4, max_ctx=40,
                                          chunk_tokens=3, page_size=4,
                                          fused=False), device="cpu")
    for p in PROMPTS[:3]:
        eng.submit_chunked(p, max_new=4)
    eng.run()
    assert eng.stats["step_ns"] > 0
    assert all(eng.stats[k] == 0 for k in COUNTERS if k != "step_ns")


class _Counting:
    """Stands in for ``record_function``, counting the ranges entered."""
    entered = 0

    def __init__(self, real):
        self.real = real

    def __call__(self, name, *a, **k):
        _Counting.entered += 1
        return self.real(name, *a, **k)


def _records(eng):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in rec.items()} for rec in eng.trace]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_spans_only_while_profiling_and_tokens_unchanged(setup, setting,
                                                         monkeypatch):
    cfg, params = setup
    monkeypatch.setattr(autograd_profiler, "record_function",
                        _Counting(autograd_profiler.record_function))
    _Counting.entered = 0
    off, tokens_off = _serve(cfg, params, setting)
    assert _Counting.entered == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on, tokens_on = _serve(cfg, params, setting)
    assert _Counting.entered > 0
    assert tokens_on == tokens_off
    assert _records(on) == _records(off)


def _wrap(monkeypatch, cls, name):
    step = cls.step

    def traced(self, *a, **k):
        with torch.profiler.record_function(name):
            return step(self, *a, **k)
    monkeypatch.setattr(cls, "step", traced)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_spans_are_host_only_leaves_inside_their_step(setup, setting,
                                                      monkeypatch):
    cfg, params = setup
    _wrap(monkeypatch, Engine, "test.engine_step")
    _wrap(monkeypatch, Scheduler, "test.scheduler_step")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(cfg, params, setting)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    spans = [e for e in events if e[0].startswith("repro_torch.")]
    assert {e[0] for e in spans} == set(SPANS)
    engine_steps = [e for e in events if e[0] == "test.engine_step"]
    sched_steps = [e for e in events if e[0] == "test.scheduler_step"]
    ops = [e for e in events if e[0].startswith("aten::")]
    assert ops

    def inside(e, outer):
        return any(o[1] <= e[1] and e[2] <= o[2] for o in outer)

    for e in spans:
        if e[0] == "repro_torch.scheduler.admit":
            assert inside(e, sched_steps) and not inside(e, engine_steps)
        else:
            assert inside(e, engine_steps), e
        assert not any(e[1] < o[1] < e[2] or e[1] < o[2] < e[2]
                       for o in ops), f"{e[0]} encloses an aten op"
        assert not any(o is not e and e[1] <= o[1] and o[2] <= e[2]
                       for o in spans), f"{e[0]} encloses a span"

"""The readers of the engine's host timers (``Engine.stats``: ``step_ns``,
``sync_wait_ns``, ``boundary_host_ns``, ``launch_ns``,
``prefill_pass_ns``, ``prefill_passes``), on short decode and chat runs
at small widths on the CPU: each reads a number from the window's
counters, the split of a step adds up, and on a program that keeps no
such counters each reads nothing and does not raise."""
import pytest

from portbench import harness, run
from portbench.readers import counter_delta
from portbench.tests import small

DECODE = "deepseek-moe-16b.decode-closed8"
CHAT = "deepseek-moe-16b.chat-open"
READERS = {DECODE: ("host_exposed_ms.decode", "sync_wait_ms.decode",
                    "boundary_host_ms.decode", "launch_ms.decode"),
           CHAT: ("host_exposed_ms.chat", "prefill_pass_ms.chat")}
COUNTERS = ("step_ns", "sync_wait_ns", "boundary_host_ns", "launch_ns",
            "prefill_pass_ns", "prefill_passes")


def _ctx(cell):
    mix = dict(small.SHORT_SERVING)
    check = dict(harness.cell(cell)["check"], min_tokens=10)
    cu = {"warmup_s": 0.3, "serve": {"max_ctx": 64}, "check": check}
    if cell == CHAT:
        mix.update(rate=6.0, preroll_s=0.3)
        cu["drain_s"] = 20.0
    return small.small_context(cell, seconds=1.0, mix_update=mix,
                               cell_update=cu)


@pytest.fixture(scope="module", params=[DECODE, CHAT])
def served(request):
    ctx = _ctx(request.param)
    out = run.execute(ctx)
    assert out["correct"], out["checks"]
    return ctx


def _read(ctx, name):
    return harness.metric_reader(name).read(ctx)


def test_the_entries_name_these_readers():
    per = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for cell, names in READERS.items():
        for name in names:
            assert per[name]["workloads"] == [cell]
            assert per[name]["source"] == "program_counter"


def test_each_reader_reads_a_number(served):
    for name in READERS[served.cell_name]:
        value = _read(served, name)
        assert isinstance(value, float) and value >= 0.0, name
    if served.cell_name == CHAT:
        assert counter_delta(served, "prefill_passes") > 0
        assert _read(served, "prefill_pass_ms.chat") > 0.0


def test_the_step_splits_into_its_parts(served):
    n = counter_delta(served, "iterations")
    step_ms = counter_delta(served, "step_ns") / n / 1e6
    exposed = _read(served, READERS[served.cell_name][0])
    waited = counter_delta(served, "sync_wait_ns") / n / 1e6
    assert waited + exposed == pytest.approx(step_ms, rel=1e-9)
    assert step_ms <= 1e3 * served.window_s / n
    if served.cell_name == DECODE:
        assert _read(served, "sync_wait_ms.decode") == pytest.approx(waited)
        parts = (_read(served, "boundary_host_ms.decode")
                 + _read(served, "launch_ms.decode") + waited)
        assert 0.0 < parts <= step_ms


def test_a_program_without_the_counters_reads_nothing(served):
    bare = harness.Context(served.cell_name, served.cell, served.conf,
                           served.mix, served.seed, served.seconds, True)
    bare.window = served.window
    bare.counters = {side: {k: v for k, v in c.items() if k not in COUNTERS}
                     for side, c in served.counters.items()}
    for name in READERS[served.cell_name]:
        assert _read(bare, name) is None, name

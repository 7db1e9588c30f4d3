"""CUDA graphs of the scoring call (``models.graphs`` behind ``loss_fn``).

On the CPU, with the capture stood in for: which calls replay (autograd
recording, CPU tensors, a mesh or layout never do), the first call of a
setting runs eagerly, the second captures, later ones replay; another
setting, other parameter storage or freed parameters drop the graph; a
capture that fails leaves its setting eager; an option with no value to
key on runs eagerly.

Tests marked ``chip`` hold the replays on the card to the eager call's
bits over new batches, with the kernels' ``LAUNCHES`` counting each call
as eager ones do, and a call that cannot be captured falls back to the
eager path; they skip without a card:

    PYTHONPATH=src python -m pytest tests/test_torch_graphs.py -m chip
"""
import gc

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as kmd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import streamed_moe as sm
from repro_torch.models import api, graphs
from repro_torch.parallel import sharding

ARCH = "granite-moe-1b-a400m"


@pytest.fixture
def card():
    """The CUDA card for a test marked ``chip``; decided when the test
    runs, never while the module is imported, and a skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    """A clean graph store and counters for the test."""
    monkeypatch.setattr(graphs, "_kept", {"key": None, "graph": None})
    monkeypatch.setattr(graphs, "_eager", set())
    monkeypatch.setattr(graphs, "CAPTURES", 0)
    monkeypatch.setattr(graphs, "REPLAYS", 0)


class _FakeGraph:
    """Stands in for a capture on the CPU: runs the call at capture and at
    each replay, and records both."""
    made = []

    def __init__(self, fn, params, batch, cfg, kw):
        self.fn, self.cfg, self.kw = fn, cfg, kw
        # copies: the graph holds no reference to the parameters
        self.params = {k: v.clone() for k, v in params.items()}
        self.replays = 0
        _FakeGraph.made.append(self)

    def replay(self, batch):
        self.replays += 1
        return self.fn(self.params, batch, self.cfg, **self.kw)


class _FailingGraph:
    def __init__(self, *a):
        raise RuntimeError("operation not permitted when stream is capturing")


def _fn(calls):
    def fn(params, batch, cfg, **kw):
        calls.append(kw)
        return params["w"].sum() + batch["tokens"].sum()
    return fn


@pytest.fixture
def stand_in(monkeypatch, fresh):
    _FakeGraph.made = []
    monkeypatch.setattr(graphs, "replayable", lambda batch: True)
    monkeypatch.setattr(graphs, "_Graph", _FakeGraph)


def _batch(v=1.0):
    return {"tokens": torch.full((2, 3), v)}


def test_second_call_captures_and_later_calls_replay(stand_in):
    calls, params = [], {"w": torch.ones(4)}
    fn = _fn(calls)
    with torch.no_grad():
        outs = [graphs.call(fn, params, _batch(v), "cfg", use_flash=True)
                for v in (1.0, 2.0, 3.0, 4.0)]
    assert [float(o) for o in outs] == [10.0, 16.0, 22.0, 28.0]
    assert len(_FakeGraph.made) == 1 and _FakeGraph.made[0].replays == 3
    assert graphs.CAPTURES == 1
    assert len(calls) == 4 and all(kw == {"use_flash": True} for kw in calls)


@pytest.mark.parametrize("change", ["option", "config", "shape", "storage",
                                   "kernels"])
def test_another_setting_drops_the_graph(stand_in, change):
    calls, params = [], {"w": torch.ones(4)}
    fn = _fn(calls)
    with torch.no_grad():
        for _ in range(2):
            graphs.call(fn, params, _batch(), "cfg", use_flash=True)
        g = graphs._kept["graph"]
        assert g is not None
        kw, cfg, batch = {"use_flash": True}, "cfg", _batch()
        if change == "option":
            kw = {"use_flash": False}
        elif change == "config":
            cfg = "other cfg"
        elif change == "shape":
            batch = {"tokens": torch.ones(2, 4)}
        elif change == "storage":
            params = {"w": torch.ones(4)}
        with kops.use_kernels(change != "kernels"):
            graphs.call(fn, params, batch, cfg, **kw)
            assert graphs._kept["graph"] is None       # eager: a warm-up
            graphs.call(fn, params, batch, cfg, **kw)
    assert graphs._kept["graph"] is not g and graphs.CAPTURES == 2


def test_freed_parameters_drop_the_graph(stand_in):
    params = {"w": torch.ones(4)}
    fn = _fn([])
    with torch.no_grad():
        for _ in range(2):
            graphs.call(fn, params, _batch(), "cfg")
    assert graphs._kept["graph"] is not None
    del params
    gc.collect()
    assert graphs._kept == {"key": None, "graph": None}


def test_failed_capture_leaves_the_setting_eager(stand_in, monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _FailingGraph)
    calls, params = [], {"w": torch.ones(4)}
    fn = _fn(calls)
    with torch.no_grad():
        outs = [float(graphs.call(fn, params, _batch(), "cfg"))
                for _ in range(4)]
    assert outs == [10.0] * 4 and len(calls) == 4
    assert len(graphs._eager) == 1 and graphs.CAPTURES == 0
    monkeypatch.setattr(graphs, "_Graph", _FakeGraph)
    with torch.no_grad():
        graphs.call(fn, params, _batch(), "cfg")
    assert _FakeGraph.made == []


def test_option_with_no_value_to_key_on_runs_eagerly(stand_in):
    params = {"w": torch.ones(4)}
    fn = _fn([])
    with torch.no_grad():
        for _ in range(3):
            graphs.call(fn, params, _batch(), "cfg", spec={"strategy": "x"})
    assert _FakeGraph.made == [] and graphs._kept["key"] is None


def test_which_calls_may_replay(fresh):
    cpu = _batch()
    with torch.no_grad():
        assert not graphs.replayable(cpu)
    assert not graphs.replayable({"n": 3})


def test_storage_keys_on_address_shape_and_strides():
    a = torch.zeros(4, 6)
    s = graphs._storage({"a": a, "t": (a, 2)})
    assert s == graphs._storage({"a": a, "t": (a, 2)})
    assert s != graphs._storage({"a": a.clone(), "t": (a, 2)})
    assert graphs._storage(a.t()) != graphs._storage(a)
    assert graphs._storage(a[:2]) != graphs._storage(a)


def test_loss_fn_on_the_cpu_keeps_no_graph(fresh):
    cfg = reduced_config(ARCH)
    params = api.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8))
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        a, _ = api.loss_fn(params, batch, cfg)
        b, _ = api.loss_fn(params, batch, cfg)
    assert torch.equal(a, b) and graphs._kept["key"] is None
    assert graphs.CAPTURES == graphs.REPLAYS == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_case(card, dtype="bfloat16"):
    """Granite at its widths (flash at hd 64, the capacity MoE), 2 layers."""
    cfg = get_config(ARCH).replace(num_layers=2, dtype=dtype)
    params = api.init_params(cfg, seed=0, device=card)
    g = torch.Generator(device=card).manual_seed(3)

    def batch():
        t = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                          device=card)
        return {"tokens": t, "labels": torch.cat(
            [t[:, 1:], torch.full((2, 1), -1, device=card)], dim=1)}
    return cfg, params, batch


def _bits(loss, parts):
    return [x.float().view(torch.int32).item()
            for x in (loss, parts["ce"], parts["aux"])]


@pytest.mark.chip
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_replays_hold_the_eager_bits_on_card(card, fresh, dtype):
    cfg, params, batch = _card_case(card, dtype)
    n_layers = cfg.num_layers
    batches = [batch() for _ in range(4)]
    with torch.no_grad():
        want = [_bits(*api._loss(params, b, cfg, spec=None, remat=False,
                                 use_flash=True, unshard=False))
                for b in batches]
        got, counts = [], []
        for b in batches:
            n = (fa.LAUNCHES, sm.LAUNCHES, kmd.LAUNCHES)
            out = api.loss_fn(params, b, cfg, use_flash=True)
            counts.append((fa.LAUNCHES - n[0], sm.LAUNCHES - n[1],
                           kmd.LAUNCHES - n[2]))
            got.append(out)
        torch.cuda.synchronize()
    assert [_bits(*o) for o in got] == want
    assert graphs.CAPTURES == 1 and graphs.REPLAYS == 3
    # each call counts the launches the eager call makes
    assert counts == [counts[0]] * 4
    assert counts[0][0] == n_layers and counts[0][1] == n_layers
    assert counts[0][2] == 2 * n_layers


@pytest.mark.chip
def test_uncapturable_call_runs_eagerly_on_card(card, fresh):
    cfg, params, batch = _card_case(card)

    def fn(params, batch, cfg, **kw):
        loss, parts = api._loss(params, batch, cfg, **kw)
        loss.item()                  # a read back: not capturable
        return loss, parts
    b = batch()
    stream = torch.cuda.current_stream()
    kw = dict(spec=None, remat=False, use_flash=True, unshard=False)
    with torch.no_grad():
        want = _bits(*api._loss(params, b, cfg, **kw))
        outs = [_bits(*graphs.call(fn, params, b, cfg, **kw))
                for _ in range(3)]
    assert outs == [want] * 3 and len(graphs._eager) == 1
    assert torch.cuda.current_stream() == stream
    assert graphs.CAPTURES == 0


@pytest.mark.chip
def test_autograd_and_layouts_never_replay_on_card(card, fresh):
    cfg, params, batch = _card_case(card)
    b = batch()
    for _ in range(2):
        api.loss_fn(params, b, cfg, use_flash=False)
    assert graphs._kept["key"] is None
    with torch.no_grad(), sharding.with_layout(object()):
        assert not graphs.replayable(b)

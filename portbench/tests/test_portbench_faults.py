"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the program on the CPU at
small widths.  (One card, no exchange between chips: that fault has no
cell.)  The serving cells' own limit holds at these widths; the scoring
cell's limits are set for 24 layers of width 1024, where a fault moves
the loss several times as far, so at two layers of width 64 the scoring
runs hold a limit of ``SMALL_SCORING_LIMIT`` on every number (the sound
float32 program reads under 1e-6 there; the faults, 1e-2 and more).  The
unbroken program comes out correct on the same runs."""
import pytest

from portbench import run
from portbench.tests import small

SERVING = ("deepseek-moe-16b.decode-closed8", "deepseek-moe-16b.chat-open")
SCORING = "granite-moe-1b-a400m.score-2x2048"


def _serving_ctx(cell):
    from portbench import harness
    mix = dict(small.SHORT_SERVING)
    # the cell's limits; fewer served tokens to compare at small widths
    check = dict(harness.cell(cell)["check"], min_tokens=10)
    cu = {"warmup_s": 0.3, "serve": {"max_ctx": 64}, "check": check}
    if "chat" in cell:
        mix.update(rate=6.0, preroll_s=0.3)
        cu["drain_s"] = 20.0
    return small.small_context(cell, seconds=1.0, mix_update=mix,
                               cell_update=cu)


SMALL_SCORING_LIMIT = 1e-3


def _scoring_ctx():
    from portbench import harness
    # the probe among the window's first call, which even a short window
    # on the CPU makes
    chk = harness.cell(SCORING)["check"]
    check = dict(chk, among_first=1, calls=1, positions=8,
                 limits={k: SMALL_SCORING_LIMIT for k in chk["limits"]})
    return small.small_context(SCORING, seconds=0.5,
                               mix_update={"batch": 2, "seq": 48},
                               cell_update={"check": check})


def _token_altered(monkeypatch, vocab_of):
    from repro_torch.serving import engine
    sample = engine.Engine._sample
    monkeypatch.setattr(engine.Engine, "_sample", lambda self, lf: (
        sample(self, lf) + 1) % self.cfg.vocab_size)


def _state_unchanged(monkeypatch, _):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "decode_moe_exec",
                        lambda params, x, *a, **k: x)


@pytest.mark.parametrize("cell", SERVING)
def test_serving_sound(cell):
    out = run.execute(_serving_ctx(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVING)
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged])
def test_serving_faults(cell, fault, monkeypatch):
    fault(monkeypatch, None)
    out = run.execute(_serving_ctx(cell))
    assert not out["correct"]
    gap = out["checks"]["mean_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_scoring_sound():
    out = run.execute(_scoring_ctx())
    assert out["correct"], out["checks"]


def _half_batch(monkeypatch):
    from repro_torch.models import api
    loss_fn = api.loss_fn
    monkeypatch.setattr(api, "loss_fn", lambda params, batch, cfg, **k:
                        loss_fn(params, {n: t[:t.shape[0] // 2]
                                         for n, t in batch.items()}, cfg, **k))


def _answer_altered(monkeypatch):
    from repro_torch.models import api
    loss_fn = api.loss_fn
    monkeypatch.setattr(api, "loss_fn", lambda *a, **k: (
        lambda r: (r[0] * 1.01, r[1]))(loss_fn(*a, **k)))


def _moe_dropped(monkeypatch):
    from repro_torch.models import moe
    block = moe.moe_block
    monkeypatch.setattr(moe, "moe_block", lambda *a, **k: (
        lambda r: (r[0] * 0,) + tuple(r[1:]) if isinstance(r, tuple)
        else r * 0)(block(*a, **k)))


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered,
                                   _moe_dropped])
def test_scoring_faults(fault, monkeypatch):
    fault(monkeypatch)
    out = run.execute(_scoring_ctx())
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _fp8_serving(cell):
    ctx = _serving_ctx(cell)
    ctx.cell = dict(ctx.cell, serve=dict(ctx.cell["serve"],
                                         spec={"weight_dtype": "fp8"}))
    return ctx


@pytest.mark.parametrize("cell", SERVING)
def test_serving_fp8_path_is_not_the_stated_precision(cell):
    """The program's own fp8 expert path, switched on, runs another
    configuration than the bf16 one stated: not correct."""
    ctx = _fp8_serving(cell)
    ctx.conf = dict(ctx.conf, dtype="bfloat16")
    ctx.model_cfg = ctx.model_cfg.replace(dtype="bfloat16")
    out = run.execute(ctx)
    bits = out["checks"]["expert_weight_bits"]
    assert not out["correct"] and bits["value"] == 8 and bits["limit"] == 16


def test_scoring_fp8_path_is_not_the_stated_precision():
    from repro_torch.kernels import quant
    with quant.use_weight_dtype("fp8"):
        out = run.execute(_scoring_ctx())
    bits = out["checks"]["expert_weight_bits"]
    assert not out["correct"] and bits["value"] == 8 and bits["limit"] == 16

"""The optimizer, gradient compression, data pipeline and checkpoint
manager of the training slice: port vs reference, on the CPU.

* ``adamw.apply`` from zeros and from a carried step-7 state (bias
  corrections at step 8), fp32 and bf16 optimizer state, on a tree of
  fp32 and bf16 parameters, with a cosine schedule and clipping that
  binds: new parameters, moments, step and grad norm.  The arithmetic is
  the reference's, element by element; the global norm sums its leaves
  in the reference's order, but the two libraries' reductions may
  associate them differently, so fp32 leaves are held within OPT_RTOL
  (3e-6, some 25 fp32 ulps) and bf16 ones within one bf16 ulp of the
  reference's (an fp32 ulp of difference can flip a bf16 rounding).
* ``cosine_schedule``, ``global_norm`` and ``clip_by_global_norm``
  within OPT_RTOL.
* ``compress_tree`` == the reference's bit for bit, and the reference's
  error-feedback round trip.
* ``SyntheticLM`` batches == the reference's bit for bit.
* The reference's five checkpoint tests (``tests/test_checkpoint.py``)
  on torch trees, plus a params checkpoint the reference wrote (reduced
  granite, bf16) restored by the port == ``bridge.from_reference_params``
  bit for bit, with the reference's keys.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import manager as jckpt
from repro.configs import reduced_config as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import bridge, tree
from repro_torch.checkpointing import manager as M
from repro_torch.data import DataConfig, SyntheticLM, batch_for
from repro_torch.optim import adamw, compress

OPT_RTOL = 3e-6             # about 25 fp32 ulps (2^-23 each)
BF16_ULP = 2.0 ** -7         # relative spacing of bf16 values


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"b": f(5), "a": (f(3, 4), {"z": f(2, 3), "c": f(7)}),
            "h": f(6, 2)}


BF16_KEYS = ("a/1/z",)        # these leaves are bf16 parameters


def _as_jax(t, bf16_paths=()):
    def conv(path, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if path in bf16_paths else a
    flat = list(tree.leaves_with_path(t))
    return tree.unflatten(t, [conv(p, a) for p, a in flat])


def _state(params_np, dt, step, seed):
    """A reference AdamWState at ``step`` with random moments in ``dt``."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, dt), params_np)
    v = jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape) * 0.01, dt),
                     params_np)
    return jadamw.AdamWState(jnp.asarray(step, jnp.int32), m, v)


def _close(got, want, dtype):
    got = bridge.to_numpy(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = BF16_ULP if dtype == torch.bfloat16 else OPT_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(
        want).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 7])
def test_adamw_apply_matches_reference(start, state_dtype):
    pnp, gnp = _np_tree(0), _np_tree(1, scale=3.0)
    jparams = _as_jax(pnp, BF16_KEYS)
    jgrads = _as_jax(gnp, BF16_KEYS)
    sched = dict(base_lr=1e-2, warmup=3, total=20)
    jstate = _state(pnp, jnp.dtype(state_dtype), start, 2) if start else \
        jadamw.init(jparams, jnp.dtype(state_dtype))
    to_np = lambda t: jax.tree.map(lambda a: np.asarray(a), t)
    params = bridge.from_reference_params(to_np(jparams), "cpu")
    grads = bridge.from_reference_params(to_np(jgrads), "cpu")
    state = bridge.from_reference_opt_state(to_np(jstate), "cpu")
    if start == 0:
        assert all(torch.equal(a, torch.zeros_like(a)) for a in
                   tree.leaves(adamw.init(params, state_dtype).m))
    jp, js, jm = jadamw.apply(jparams, jgrads, jstate,
                              lr=jadamw.cosine_schedule(**sched),
                              weight_decay=0.1, max_grad_norm=1.0)
    p, s, m = adamw.apply(params, grads, state,
                          lr=adamw.cosine_schedule(**sched),
                          weight_decay=0.1, max_grad_norm=1.0)
    assert int(s.step) == int(js.step) == start + 1
    assert float(jm["grad_norm"]) > 1.0          # the clip binds
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=OPT_RTOL)
    for (path, got), want in zip(tree.leaves_with_path(p), jax.tree.leaves(jp)):
        assert got.dtype == (torch.bfloat16 if path in BF16_KEYS
                             else torch.float32), path
        _close(got, want, got.dtype)
    for part in ("m", "v"):
        for got, want in zip(tree.leaves(getattr(s, part)),
                             jax.tree.leaves(getattr(js, part))):
            _close(got, want, got.dtype)


def test_schedule_and_clipping_match_reference():
    sched, jsched = (adamw.cosine_schedule(3e-3, 5, 40),
                     jadamw.cosine_schedule(3e-3, 5, 40))
    for step in range(0, 46, 3):
        np.testing.assert_allclose(float(sched(torch.tensor(step))),
                                   float(jsched(jnp.asarray(step))),
                                   rtol=OPT_RTOL, atol=1e-12)
    gnp = _np_tree(4, scale=2.0)
    jg, norm_j = jadamw.clip_by_global_norm(_as_jax(gnp), 1.0)
    g, norm = adamw.clip_by_global_norm(
        bridge.from_reference_params(gnp, "cpu"), 1.0)
    np.testing.assert_allclose(float(norm), float(norm_j), rtol=OPT_RTOL)
    np.testing.assert_allclose(float(adamw.global_norm(g)),
                               float(jadamw.global_norm(jg)), rtol=OPT_RTOL)
    for a, b in zip(tree.leaves(g), jax.tree.leaves(jg)):
        _close(a, b, torch.float32)


def test_compress_tree_matches_reference():
    gnp = _np_tree(5)
    jdeq, jres = jcompress.compress_tree(_as_jax(gnp))
    jdeq2, jres2 = jcompress.compress_tree(_as_jax(_np_tree(6)), jres)
    g = bridge.from_reference_params(gnp, "cpu")
    deq, res = compress.compress_tree(g)
    deq2, res2 = compress.compress_tree(
        bridge.from_reference_params(_np_tree(6), "cpu"), res)
    for got, want in zip(tree.leaves((deq, res, deq2, res2)),
                         jax.tree.leaves((jdeq, jres, jdeq2, jres2))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert compress.compressed_bytes_ratio(8) == \
        jcompress.compressed_bytes_ratio(8)


def test_compress_roundtrip_error_feedback():
    """The reference's own round trip (tests/test_train.py)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))}
    deq, res = compress.compress_tree(g)
    np.testing.assert_allclose((g["w"] - deq["w"]).numpy(),
                               res["w"].numpy(), rtol=1e-6, atol=1e-7)
    z = {"w": torch.zeros((64, 64))}
    deq2, res2 = compress.compress_tree(z, res)
    np.testing.assert_allclose((deq2["w"] + res2["w"]).numpy(),
                               res["w"].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 32, 8, 3),
                                                  (49155, 64, 2, 0)])
def test_synthetic_batches_match_reference(vocab, seq, batch, seed):
    cfg = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    jdata = JSyntheticLM(JDataConfig(vocab_size=vocab, seq_len=seq,
                                     global_batch=batch, seed=seed))
    data = SyntheticLM(cfg)
    for step in (0, 1, 17):
        got, want = data.batch(step), jdata.batch(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(batch_for(cfg, 1)["tokens"],
                                  jdata.batch(1)["tokens"])


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, on torch trees
# ---------------------------------------------------------------------------


def _tree(x=1.0):
    return {"a": torch.full((4, 4), x),
            "b": {"c": torch.arange(6, dtype=torch.int32)}}


def test_save_restore_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        M.save(d, 10, _tree(2.5), extra={"note": "hi"})
        got, step, extra = M.restore(d, _tree(0.0))
        assert step == 10 and extra["note"] == "hi"
        np.testing.assert_array_equal(got["a"].numpy(), 2.5)
        assert torch.equal(got["b"]["c"], torch.arange(6, dtype=torch.int32))


def test_latest_pointer_and_gc():
    with tempfile.TemporaryDirectory() as d:
        for s in (10, 20, 30, 40):
            M.save(d, s, _tree(float(s)))
        assert M.latest_step(d) == 40
        M.gc_old(d, keep=2)
        assert M.all_steps(d) == [30, 40]
        _, step, _ = M.restore(d, _tree(0.0))
        assert step == 40


def test_crash_during_write_leaves_previous_intact():
    """A stale .tmp dir (simulated mid-write crash) must not break restore;
    nor a pointer ahead of the steps on disk."""
    with tempfile.TemporaryDirectory() as d:
        M.save(d, 10, _tree(1.0))
        os.makedirs(os.path.join(d, "step_00000020.tmp-999"))
        assert M.latest_step(d) == 10
        _, step, _ = M.restore(d, _tree(0.0))
        assert step == 10
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("step_00000020")
        assert M.latest_step(d) == 10


def test_missing_key_raises():
    with tempfile.TemporaryDirectory() as d:
        M.save(d, 1, {"a": torch.zeros((2,))})
        with pytest.raises(KeyError):
            M.restore(d, _tree(0.0))


def test_restore_casts_dtype():
    with tempfile.TemporaryDirectory() as d:
        M.save(d, 1, {"a": torch.ones((3,), dtype=torch.float32)})
        got, _, _ = M.restore(d, {"a": torch.zeros((3,),
                                                   dtype=torch.bfloat16)})
        assert got["a"].dtype == torch.bfloat16
        assert torch.equal(got["a"], torch.ones((3,), dtype=torch.bfloat16))


def test_reference_params_checkpoint_restores_into_the_port():
    """The reference's keys and layout: its bf16 params of reduced granite
    come back as ``bridge.from_reference_params`` gives them, bit for bit,
    and the port writes the same keys."""
    jparams = japi.init_params(jax.random.PRNGKey(0),
                               jreduced("granite-moe-1b-a400m"))
    want = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    like = tree.map(torch.zeros_like, want)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 3, {"params": jparams})
        got, step, _ = M.restore(d, {"params": like})
        assert step == 3
        with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
            ref_keys = sorted(z.files)
    with tempfile.TemporaryDirectory() as d:
        M.save(d, 3, {"params": want})
        with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
            assert sorted(z.files) == ref_keys
    for (path, g), (_, w) in zip(tree.leaves_with_path(got["params"]),
                                 tree.leaves_with_path(want)):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), path

"""The trainer: port vs reference, and the reference's own trainer checks,
on the CPU (reduced granite-moe-1b-a400m, fp32).

* 5 steps of ``make_train_step`` under ``capacity`` (the streamed_moe
  path) from the reference's initial parameters, carried through the
  bridge, on the same ``SyntheticLM`` batches, against the reference's
  jitted ``step_fn`` (its jnp oracle, ``use_kernels(False)``): each
  step's loss within 1e-5 relative, and each final parameter leaf within
  PARAM_TOL of the leaf's largest magnitude (fp32 sums in other orders,
  carried through five AdamW updates).
* A crash at step 4 and an auto-resume from the step-4 checkpoint == a
  straight 6-step run: the final loss within the reference's
  ``rtol=1e-5`` (``tests/test_train.py``), and on the CPU the final
  parameters bit for bit.
* The reference's convergence checks with its own settings and bounds:
  the loss falls by more than 0.5 in 60 steps, and int8 compression with
  error feedback ends within 0.35 of the uncompressed run after 40.
* ``python -m repro_torch.launch.train --reduced --device cpu --steps 3``
  exits 0.
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro_torch import bridge, tree
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig
from repro_torch.optim import adamw
from repro_torch.training import TrainConfig, make_train_step, train

ARCH = "granite-moe-1b-a400m"
CFG = reduced_config(ARCH).replace(dtype="float32")
DCFG = DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=8,
                  seed=3)
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


def test_train_steps_match_reference():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    tc = dict(total_steps=20, warmup=2, lr=3e-3, moe_spec="capacity")
    data = JSyntheticLM(JDataConfig(vocab_size=CFG.vocab_size, seq_len=32,
                                    global_batch=4, seed=3))
    want = []
    with jops.use_kernels(False):
        jstep = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**tc))
        jstate, res = jadamw.init(jparams), jnp.zeros(())
        for s in range(5):
            batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            jparams, jstate, res, m = jstep(jparams, jstate, batch, res)
            want.append(float(m["loss"]))
    for p in tree.leaves(params):
        p.requires_grad_(True)
    state, res = adamw.init(params), torch.zeros(())
    step = make_train_step(CFG, TrainConfig(**tc))
    got = []
    for s in range(5):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(s).items()}
        params, state, res, m = step(params, state, batch, res)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert int(state.step) == int(jstate.step) == 5
    for (path, p), w in zip(tree.leaves_with_path(params),
                            jax.tree.leaves(jparams)):
        w = np.asarray(w)
        assert np.abs(p.detach().numpy() - w).max() <= \
            PARAM_TOL * np.abs(w).max(), path


def test_crash_resume_matches_straight_run():
    tc = dict(total_steps=6, warmup=2, lr=3e-3, ckpt_every=2, log_every=1,
              moe_spec="capacity")
    with tempfile.TemporaryDirectory() as d1:
        straight = train(CFG, DCFG, TrainConfig(ckpt_dir=d1, **tc), seed=0,
                         device="cpu")
    with tempfile.TemporaryDirectory() as d2:
        with pytest.raises(RuntimeError, match="preemption"):
            train(CFG, DCFG, TrainConfig(ckpt_dir=d2, **tc), seed=0,
                  crash_at_step=4, device="cpu")
        resumed = train(CFG, DCFG, TrainConfig(ckpt_dir=d2, **tc), seed=0,
                        device="cpu")
    assert resumed.resumed_from == 4
    assert [s for s, _ in resumed.losses] == [4, 5]
    np.testing.assert_allclose(straight.losses[-1][1], resumed.losses[-1][1],
                               rtol=LOSS_RTOL)
    for a, b in zip(tree.leaves(straight.params), tree.leaves(resumed.params)):
        assert torch.equal(a, b)


def test_loss_decreases():
    r = train(CFG, DCFG, TrainConfig(total_steps=60, warmup=5, lr=3e-3,
                                     log_every=10), seed=0, device="cpu")
    first, last = r.losses[0][1], r.losses[-1][1]
    assert last < first - 0.5, (first, last)


def test_grad_compression_converges():
    base = train(CFG, DCFG, TrainConfig(total_steps=40, warmup=5, lr=3e-3,
                                        log_every=39), seed=0, device="cpu")
    comp = train(CFG, DCFG, TrainConfig(total_steps=40, warmup=5, lr=3e-3,
                                        log_every=39, grad_compress_bits=8),
                 seed=0, device="cpu")
    assert abs(base.losses[-1][1] - comp.losses[-1][1]) < 0.35


def test_train_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path
                                                      if p))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 3 steps" in out.stdout

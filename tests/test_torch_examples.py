"""The port's four examples (``examples/*_torch.py``) on the CPU, in-process.

* quickstart at 2 gloo ranks: step 1's micro-slice sum held against the
  reference's ``ref.streamed_moe_ref`` on the same numpy inputs (2e-5 of
  max |y|, fp32 ``streamed_moe``'s tolerance); step 2's strategies and
  forced FSE-DP modes within the example's 2e-4 of the dense oracle; step
  3's two simulated layers ``==`` the reference simulator's;
* the serve example: identical outputs with and without token buffering
  (the example raises otherwise), buffering deferring and saving loads;
* the training example: 3 steps into a checkpoint, then a resume to 5
  steps from it, whose first loss is that of the first run's parameters on
  step 3's batch (1e-6 relative);
* the simulator example: 12 finite speedups and savings;
* each one raises, with no CPU fallback, when it is asked for ``cuda``
  (its default) and there is none.
"""
import importlib
import math
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.sim import PAPER_SPECS as JSPECS
from repro.sim import PROTOTYPE_2X2 as JHW
from repro.sim import iteration_workloads as jworkloads
from repro.sim import simulate_layer as jsimulate

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("quickstart_torch", "serve_low_batch_torch", "train_moe_100m_torch",
         "expert_streaming_sim_torch")
STEP1_TOL = 2e-5
LOSS_RTOL = 1e-6


def _example(name):
    """The example as a module; its directory on sys.path, so gloo ranks
    spawned from it import it by name."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_quickstart_at_two_ranks(capsys):
    qs = _example("quickstart_torch")
    res = qs.main(["--device", "cpu", "--ranks", "2"])
    xe, wg, wu, wd, _ = qs.micro_slice_inputs()
    want = np.asarray(jref.streamed_moe_ref(
        *(jnp.asarray(a) for a in (xe, wg, wu, wd)), "swiglu"))
    np.testing.assert_allclose(res["parts"].numpy(), want, rtol=0,
                               atol=STEP1_TOL * np.abs(want).max())
    assert sorted(res["step2"]) == sorted(
        list(qs.STRATEGIES) + [f"fse_dp:{m}" for m in qs.MODES])
    assert max(res["step2"].values()) < qs.STEP2_TOL
    wl = jworkloads(JSPECS["qwen3-a3b"], tokens_per_iter=64,
                    num_chiplets=JHW.num_chiplets, seed=0)[0]
    for strat, r in res["sim"].items():
        j = jsimulate(JHW, JSPECS["qwen3-a3b"], wl, strat)
        assert (r.latency, r.peak_buffer_bytes, r.utilization) == \
            (j.latency, j.peak_buffer_bytes, j.utilization)
    assert "ALL MODES MATCH ORACLE" in capsys.readouterr().out


def test_serve_example_outputs_identical():
    res = _example("serve_low_batch_torch").main(["--device", "cpu"])
    outs0, outs1 = res["outputs"]
    assert outs0 == outs1 and all(len(o) == 12 for o in outs0)
    eng0, eng1 = res["engines"]
    assert eng0.stats["deferrals"] == 0 and eng1.stats["deferrals"] > 0
    assert eng1.stats["expert_loads_saved"] > 0


def test_train_example_checkpoints_and_resumes(tmp_path):
    tr = _example("train_moe_100m_torch")
    argv = ["--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    try:
        _train_and_resume(tr, argv, tmp_path)
    finally:            # two checkpoints of parameters and AdamW state
        shutil.rmtree(tmp_path, ignore_errors=True)


def _train_and_resume(tr, argv, tmp_path):
    from repro_torch.checkpointing import manager as ckpt
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import api
    first = tr.main(argv + ["--steps", "3"])
    assert first.resumed_from is None
    assert [s for s, _ in first.losses] == [0, 1, 2]
    assert ckpt.latest_step(str(tmp_path)) == 3
    resumed = tr.main(argv + ["--steps", "5"])
    assert resumed.resumed_from == 3 and resumed.final_step == 5
    assert [s for s, _ in resumed.losses] == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert all(math.isfinite(v) for _, v in first.losses + resumed.losses)
    cfg = tr.build_100m_config()
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=2, seed=17)).batch(3)
    with torch.no_grad():
        loss, _ = api.loss_fn(first.params, {
            k: torch.from_numpy(v).long() for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(resumed.losses[0][1], float(loss),
                               rtol=LOSS_RTOL)


def test_sim_example():
    res = _example("expert_streaming_sim_torch").main(["--device", "cpu"])
    assert len(res["speedups"]) == len(res["savings"]) == 12
    assert all(math.isfinite(s) and s > 0 for s in res["speedups"])


@pytest.mark.parametrize("name", NAMES)
def test_examples_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        _example(name).main([])

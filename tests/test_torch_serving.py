"""The serving engine as a whole: port vs JAX on reduced granite, CPU, fp32.

The port's default engine (its fused segments, pinned bit for bit to its
eager loop by ``tests/test_torch_megastep.py``) and the JAX default
engine (fused, pinned to its eager loop by the reference's own tests, run
with ``use_kernels(False)``) serve the same prompts with the same
weights, admitted one-shot (``submit``) and in chunks
(``submit_chunked``).  Token streams, the workload trace (``counts``,
``order``, ``trajectory``, ``phase``, ``modeled_s``) and the engine
statistics, host syncs and prefill counts included, must be identical,
across schedule {static, dynamic} x slack {0, 0.2} and for int8 weights.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.kernels import streamed_moe as sm
from repro_torch.serving import Engine, ServeConfig

REPO = Path(__file__).resolve().parent.parent
ARCH = "granite-moe-1b-a400m"
STATS = ("tokens_emitted", "iterations", "deferrals", "expert_loads",
         "expert_loads_saved", "dynamic_schedules", "host_syncs",
         "prefill_chunks", "prefill_tokens")
PROMPTS = ([5, 9, 2, 77, 31], [100, 3, 64], [7, 7, 8, 1, 2, 3, 4],
           [60, 61])


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


def _serve(engine, prompts, max_new, chunked=False):
    sub = engine.submit_chunked if chunked else engine.submit
    rids = [sub(list(p), max_new=max_new) for p in prompts]
    outs = engine.run()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("schedule,slack,wdt", [
    ("static", 0.0, None), ("static", 0.2, None), ("dynamic", 0.0, None),
    ("dynamic", 0.2, None), ("static", 0.2, "int8")])
def test_engine_matches_reference(weights, schedule, slack, wdt):
    jcfg, cfg, jparams, params = weights
    spec = {"strategy": "capacity", "schedule": schedule}
    if wdt:
        spec["weight_dtype"] = wdt
    kw = dict(max_batch=4, max_ctx=32, buffering_slack=slack, theta_min=2,
              page_size=4, chunk_tokens=3, spec=spec)
    for chunked in (False, True):
        with jops.use_kernels(False):
            jeng = JEngine(jparams, jcfg, JServeConfig(**kw))
            want = _serve(jeng, PROMPTS, 12, chunked)
        before = sm.LAUNCHES
        eng = Engine(params, cfg, ServeConfig(**kw), device="cpu")
        assert eng.scfg.fused and jeng.scfg.fused
        got = _serve(eng, PROMPTS, 12, chunked)
        assert sm.LAUNCHES == before            # CPU: the plain version
        assert got == want
        assert len(eng.trace) == len(jeng.trace)
        for rec, jrec in zip(eng.trace, jeng.trace):
            assert (rec["iter"], rec["layer"], rec["phase"],
                    rec["schedule"], rec["modeled_s"]) == \
                (jrec["iter"], jrec["layer"], jrec["phase"],
                 jrec["schedule"], jrec["modeled_s"])
            np.testing.assert_array_equal(rec["counts"], jrec["counts"])
            assert rec["order"] == jrec["order"]
            assert rec.get("trajectory") == jrec.get("trajectory")
        assert {k: eng.stats[k] for k in STATS} == \
            {k: jeng.stats[k] for k in STATS}
        assert eng.last_step_modeled_s == jeng.last_step_modeled_s
        if slack:
            assert eng.stats["deferrals"] > 0
        if chunked:
            assert eng.stats["prefill_chunks"] > 0


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "3", "--max-new", "6",
         "--schedule", "dynamic", "--slack", "0.2"],
        env=env, timeout=300, capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "tokens=18" in out.stdout, out.stdout

"""Traffic, the continuous-batching scheduler and the modeled chiplet
clock: port vs JAX on the CPU.

``make_traffic`` draws the same streams as the reference, byte for byte,
for every mix; ``run_closed_loop`` over the same stream gives the same
outputs, dropped requests and metrics (fcfs and spf; iteration and
modeled clocks), the port's default engine against the JAX default
engine on reduced granite in fp32 (``use_kernels(False)``); and
``ServingCostModel`` prices a record exactly as the reference does.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.core import autotune as jautotune
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.serving import Engine as JEngine
from repro.serving import Scheduler as JScheduler
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServeConfig as JServeConfig
from repro.serving import TrafficConfig as JTrafficConfig
from repro.serving import make_traffic as jmake_traffic
from repro.serving import run_closed_loop as jrun_closed_loop
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import autotune
from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                 ServeConfig, TrafficConfig, make_traffic,
                                 run_closed_loop)

REPO = Path(__file__).resolve().parent.parent
ARCH = "granite-moe-1b-a400m"


@pytest.mark.parametrize("mix", ["poisson", "poisson+zipf_prefix",
                                 "poisson+diurnal"])
def test_make_traffic_matches_reference(mix):
    kw = dict(num_requests=24, rate=0.7, avg_prompt=9, max_prompt=20,
              max_new=6, vocab=128, seed=3, mix=mix)
    got, want = make_traffic(TrafficConfig(**kw)), \
        jmake_traffic(JTrafficConfig(**kw))
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    assert len(got) == 24


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(ARCH).replace(dtype="float32")
    cfg = reduced_config(ARCH).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(2), jcfg)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("clock", [None, "modeled"], ids=["iters", "modeled"])
@pytest.mark.parametrize("policy", ["fcfs", "spf"])
def test_closed_loop_matches_reference(weights, policy, clock):
    jcfg, cfg, jparams, params = weights
    tkw = dict(num_requests=10, rate=0.8, avg_prompt=6, max_prompt=12,
               max_new=5, vocab=cfg.vocab_size, seed=1)
    kw = dict(max_batch=3, max_ctx=24, chunk_tokens=4, page_size=4,
              spec={"strategy": "capacity", "schedule": "dynamic"})
    skw = dict(queue_capacity=4, policy=policy, starvation_limit=4)
    with jops.use_kernels(False):
        jsched = JScheduler(JEngine(jparams, jcfg, JServeConfig(**kw)),
                            JSchedulerConfig(**skw), clock=clock)
        want = jrun_closed_loop(jsched, jmake_traffic(JTrafficConfig(**tkw)))
    sched = Scheduler(Engine(params, cfg, ServeConfig(**kw), device="cpu"),
                      SchedulerConfig(**skw), clock=clock)
    got = run_closed_loop(sched, make_traffic(TrafficConfig(**tkw)))
    assert got["outputs"] == want["outputs"]
    assert got["dropped"] == want["dropped"]
    gm, wm = got["metrics"].to_dict(), want["metrics"].to_dict()
    assert gm == {k: wm[k] for k in gm}
    assert gm["completed"] + len(got["dropped"]) == 10
    assert sched.engine.stats["prefill_chunks"] > 0


@pytest.mark.parametrize("wdt", [None, "int8"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_cost_model_matches_reference(wdt, dynamic):
    from repro.configs import get_config as jget_config
    from repro.kernels import quant as jquant
    from repro_torch.kernels import quant
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (reduced_config(ARCH), jreduced(ARCH))):
        got = autotune.ServingCostModel.from_config(
            ours, weight_bytes=quant.weight_bytes(wdt))
        want = jautotune.ServingCostModel.from_config(
            theirs, weight_bytes=jquant.weight_bytes(wdt))
        assert got.expert_bytes == want.expert_bytes
        rng = np.random.default_rng(0)
        E = ours.moe.num_experts
        for counts in (np.zeros(E, np.int64), rng.integers(0, 9, E),
                       rng.integers(0, 2, E) * 40):
            assert got.layer_s(counts, dynamic=dynamic) == \
                want.layer_s(counts, dynamic=dynamic)


def test_hardware_profiles_match_reference():
    for name in ("from_chiplet", "from_chiplet_array"):
        got = getattr(autotune.HardwareProfile, name)()
        want = getattr(jautotune.HardwareProfile, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # homogeneous hardware: a hybrid partition is placement only (A.11)
    from repro.configs import get_config as jget_config
    got = autotune.ServingCostModel.from_config(get_config(ARCH))
    want = jautotune.ServingCostModel.from_config(jget_config(ARCH))
    assert got.layer_s(np.ones(32), hot=[0]) == \
        want.layer_s(np.ones(32), hot=[0]) == got.layer_s(np.ones(32))


def test_serve_cli_traffic_dry_run():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--traffic", "--dry-run"],
        env=env, timeout=300, capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "traffic: 4 completed, 0 dropped" in out.stdout, out.stdout
    assert "traffic dry-run OK" in out.stdout

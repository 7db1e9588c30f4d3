"""The modeled clock against its referee: the port's engine trace replayed
through the port's chiplet simulator.

Every trace record's closed-form ``modeled_s`` (``ServingCostModel``) must
agree with the discrete expert flow (``sim.modes.simulate_trajectory``)
within the reference's 5% per record and 2% over the trace
(``tests/test_modeled_clock.py``; the gaps as ``chip_smoke.referee_gaps``
takes them on the card's traces), on reduced granite in fp32, static and
dynamic, with the resident tier and under ``hybrid``; and the port's
``replay_trace`` must give the reference's seconds exactly on the same
trace.  At granite's full width, on routing counts alone, the port's
clock and referee equal the reference's and keep the same agreement.
``chip_smoke.phase_referee``, which gates the card's traces, passes these
CPU traces and fails one whose record is 6% off.
"""
import copy
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import autotune as jautotune
from repro.core import policies as jpolicies
from repro.sim import hardware as jhw
from repro.sim import modes as jmodes
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import autotune, policies
from repro_torch.models import api
from repro_torch.serving import Engine, ServeConfig
from repro_torch.sim import hardware as hw
from repro_torch.sim import modes, workload

ARCH = "granite-moe-1b-a400m"
PER_RECORD_TOL = 0.05
AGGREGATE_TOL = 0.02


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def params():
    cfg = reduced_config(ARCH).replace(dtype="float32")
    return cfg, api.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("spec,tiers", [
    ({"strategy": "capacity"}, {}),
    ({"strategy": "capacity", "schedule": "dynamic"}, {}),
    ({"strategy": "capacity", "schedule": "dynamic"},
     {"resident_budget_mb": 0.1}),
    ({"strategy": "hybrid", "schedule": "dynamic"},
     {"resident_budget_mb": 0.1, "hot_experts": 2}),
], ids=["static", "dynamic", "dynamic-resident", "hybrid-resident"])
def test_engine_trace_within_referee(params, spec, tiers):
    cfg, p = params
    eng = Engine(p, cfg, ServeConfig(max_batch=4, max_ctx=48, chunk_tokens=4,
                                     spec=spec, **tiers), device="cpu")
    for prompt in ((1, 2, 3, 4), (9, 8, 7), (5, 5, 5, 5, 5)):
        eng.submit_chunked(list(prompt), max_new=6)
    eng.run()
    sspec = hw.spec_from_config(eng.cfg)
    cf = eng.cfg.moe.capacity_factor
    worst, _, agg, checked, _, _ = _chip_smoke().referee_gaps(eng.trace,
                                                              sspec, cf)
    assert checked > 0
    assert worst <= PER_RECORD_TOL, worst
    assert agg <= AGGREGATE_TOL, agg
    jcfg = jreduced(ARCH)
    jspec = jhw.spec_from_config(jcfg.replace(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf)))
    assert dataclasses.asdict(jspec) == dataclasses.asdict(sspec)
    for hwc, jhwc in ((hw.PROTOTYPE_2X2, jhw.PROTOTYPE_2X2),
                      (hw.PROTOTYPE_2X2_NDP, jhw.PROTOTYPE_2X2_NDP)):
        assert modes.replay_trace(hwc, sspec, eng.trace, capacity_factor=cf) \
            == jmodes.replay_trace(jhwc, jspec, eng.trace, capacity_factor=cf)


@pytest.mark.parametrize("tokens", [1, 8, 64, 128])
def test_full_width_clock_and_referee_match_reference(tokens):
    """Granite at full width, routing counts only (no weights), drop-free
    capacity as the engine serves it: the port's ``layer_s`` and
    ``simulate_trajectory`` equal the reference's, within 5% of each
    other, static and dynamic."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    E = cfg.moe.num_experts
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=float(E)))
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=float(E)))
    cm = autotune.ServingCostModel.from_config(cfg)
    jcm = jautotune.ServingCostModel.from_config(jcfg)
    spec, jspec = hw.spec_from_config(cfg), jhw.spec_from_config(jcfg)
    rng = np.random.default_rng(tokens)
    for _ in range(4):
        probs = workload.sample_expert_probs(E, rng)
        counts = workload.route_tokens(E, cfg.moe.top_k, tokens, probs, rng)
        order = policies.paired_load_order(counts)
        assert order == jpolicies.paired_load_order(counts)
        for dyn in (False, True):
            got = cm.layer_s(counts, dynamic=dyn)
            assert got == jcm.layer_s(counts, dynamic=dyn)
            kw = dict(order=order) if dyn else dict(padded=True)
            ref = modes.simulate_trajectory(hw.PROTOTYPE_2X2, spec, counts,
                                            capacity_factor=float(E), **kw)
            assert ref == jmodes.simulate_trajectory(
                jhw.PROTOTYPE_2X2, jspec, counts, capacity_factor=float(E),
                **kw)
            assert abs(got - ref) <= PER_RECORD_TOL * ref


@pytest.mark.parametrize("fault", [None, "record", "total"])
def test_chip_smoke_referee_gate(params, fault):
    chip_smoke = _chip_smoke()
    cfg, p = params
    engines = {}
    for label, kw in (("static", dict(spec={"strategy": "capacity"})),
                      ("resident", dict(spec={"strategy": "hybrid",
                                              "schedule": "dynamic"},
                                        resident_budget_mb=0.1))):
        eng = Engine(p, cfg, ServeConfig(max_batch=4, max_ctx=48,
                                         chunk_tokens=4, **kw), device="cpu")
        for prompt in ((1, 2, 3, 4), (9, 8, 7)):
            eng.submit_chunked(list(prompt), max_new=5)
        eng.run()
        engines[label] = eng
    if fault is not None:
        eng = engines["static"]
        eng.trace = copy.deepcopy(eng.trace)
        recs = [r for r in eng.trace if "counts" in r]
        for rec in recs[:1] if fault == "record" else recs:
            rec["modeled_s"] *= 1.06 if fault == "record" else 1.03
    if fault is None:
        chip_smoke.phase_referee(engines)
    else:
        with pytest.raises(SystemExit):
            chip_smoke.phase_referee(engines)

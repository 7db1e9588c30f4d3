"""The strategy registry and the distributed planner: port vs JAX, on the CPU.

The single-device cases of ``tests/test_strategy.py``: every registered
family through ``moe_block`` on one device (the distributed ones run
``capacity``, bit for bit), ``auto`` == ``capacity``.  The planner is pure
Python on both sides, so ``mode_cost``, ``ep_cost``, ``fallback_plan``,
``plan_moe``, ``family_costs``, ``pick_family`` and ``plan_family`` must
equal the reference's with ``==`` on its ``HardwareProfile``s, over the
port's copies of the reference's sweeps (``autotune.VALIDATION_SWEEP``,
``strategy.FAMILY_SWEEP``, ``HYBRID_SWEEP``; ``test_torch_aliases.py``
holds them ``==`` the reference's).  The one stated difference is the
tiles: a port plan carries the Hopper planner's setting in ``Plan.tiles``
(none on a machine without a card) and leaves the reference's TPU tile
fields (``token_tile``, ``dmodel_tile``, ``dexpert_tile``, ``vmem_bytes``)
at their defaults.  The port's choices are also held to its own chiplet
simulator's ranking, as the reference's tests hold the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import autotune as jat
from repro.core import strategy as jstrat
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.sim import hardware as jhw
from repro_torch import bridge
from repro_torch.configs.base import MoEConfig
from repro_torch.core import autotune, baselines, fse_dp, strategy
from repro_torch.core.strategy import FAMILIES, StrategyContext
from repro_torch.models import moe as moe_mod
from repro_torch.models.mlp import ffn
from repro_torch.sim import hardware as hw
from repro_torch.sim import modes as sim_modes
from repro_torch.sim import workload

D_MODEL = 16
D_PLAN = 512
MOE_TOL = 1e-5
TILE_FIELDS = ("token_tile", "dmodel_tile", "dexpert_tile", "vmem_bytes")


def _hw(P, ndp=False):
    base = {2: hw.scaled(1, 2), 4: hw.scaled(2, 2), 8: hw.scaled(2, 4)}[P]
    return hw.with_ndp(base) if ndp else base


def _jhw(P, ndp=False):
    base = {2: jhw.scaled(1, 2), 4: jhw.scaled(2, 2), 8: jhw.scaled(2, 4)}[P]
    return jhw.with_ndp(base) if ndp else base


def _profiles(P, ndp=False):
    """(port, reference) HardwareProfile of one chiplet, field for field
    the same."""
    p = autotune.HardwareProfile.from_chiplet(_hw(P, ndp))
    jp = jat.HardwareProfile.from_chiplet(_jhw(P, ndp))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    return p, jp


def _moes(**kw):
    return MoEConfig(**kw), JMoEConfig(**kw)


def assert_same_plan(plan, jplan):
    """Every field the reference's Plan has, but the TPU tile fields, which
    stay at their defaults in the port."""
    got = {f.name: getattr(plan, f.name)
           for f in dataclasses.fields(jplan) if f.name not in TILE_FIELDS}
    want = {f.name: getattr(jplan, f.name)
            for f in dataclasses.fields(jplan) if f.name not in TILE_FIELDS}
    assert got == want
    default = autotune.Plan(mode="x", micro_slices=1)
    assert all(getattr(plan, f) == getattr(default, f) for f in TILE_FIELDS)


# ---------------------------------------------------------------------------
# the registry on one device
# ---------------------------------------------------------------------------


def _setup(E=8, k=2, de=32, cf=4.0, act="swiglu", shared=0):
    kw = dict(num_experts=E, top_k=k, d_expert=de, capacity_factor=cf,
              num_shared_experts=shared)
    moe, jm = _moes(**kw)
    jparams = jmoe.moe_init(jax.random.PRNGKey(0), D_MODEL, jm, act,
                            jnp.float32)
    params = bridge.from_reference_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return moe, jm, params, jparams


def test_registry_contents():
    for name in ("fse_dp", "ep", "tp", "capacity", "dense", "auto",
                 "hybrid"):
        s = strategy.get_strategy(name)
        assert s.name == name
        assert isinstance(s, strategy.MoEStrategy)
    assert strategy.available() == jstrat.available()
    with pytest.raises(KeyError):
        strategy.get_strategy("nope")


@pytest.mark.parametrize("family", ["dense", "capacity", "fse_dp", "ep",
                                    "tp"])
def test_forced_spec_bit_identical(family):
    """moe_block(spec=<family>) on one device: the reference's output
    within 1e-5 and its aux within 1e-6; the distributed families give
    their single-device entry's bits (``moe_fse_dp`` / ``moe_ep`` /
    ``moe_tp``, which run ``capacity`` there)."""
    moe, jm, params, jparams = _setup(shared=1)
    xn = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                      (2, 10, D_MODEL), jnp.float32))
    x = torch.from_numpy(np.array(xn))
    y, aux = moe_mod.moe_block(params, x, moe, "swiglu", spec=family,
                               return_aux=True)
    with jops.use_kernels(False):
        jy, jaux = jmoe.moe_block(jparams, jnp.asarray(xn), jm, "swiglu",
                                  spec=family, return_aux=True)
    assert np.abs(y.numpy() - np.asarray(jy)).max() \
        <= MOE_TOL * np.abs(np.asarray(jy)).max()
    assert abs(aux.item() - float(jaux)) <= 1e-6
    if family in ("fse_dp", "ep", "tp"):
        entry = {"fse_dp": fse_dp.moe_fse_dp, "ep": baselines.moe_ep,
                 "tp": baselines.moe_tp}[family]
        y_ref, aux_ref = entry(params, x, moe, "swiglu")
        y_ref = y_ref + ffn(params["shared"], x, "swiglu")
        assert torch.equal(y, y_ref) and torch.equal(aux, aux_ref)
        y_cap, aux_cap = moe_mod.moe_block(params, x, moe, "swiglu",
                                           spec="capacity", return_aux=True)
        assert torch.equal(y, y_cap) and torch.equal(aux, aux_cap)


def test_auto_single_device_equals_capacity():
    moe, _, params, _ = _setup()
    x = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(4), (3, 4, D_MODEL), jnp.float32)))
    y_auto = moe_mod.moe_block(params, x, moe, "swiglu", spec="auto")
    y_cap = moe_mod.moe_block(params, x, moe, "swiglu", spec="capacity")
    assert torch.equal(y_auto, y_cap)
    y, _ = strategy.execute(strategy.ExecutionSpec(), params, x, moe,
                            "swiglu")
    assert torch.equal(y.reshape(y_cap.shape), y_cap)


def test_single_device_plans_match_reference():
    """Each family's plan at P = 1 (the capacity fallbacks)."""
    moe, jm = _moes(num_experts=8, top_k=2, d_expert=64)
    for name in ("fse_dp", "ep", "tp", "auto", "hybrid", "capacity",
                 "dense"):
        ctx = StrategyContext(B=2, S=8, d_model=D_PLAN, moe=moe,
                              activation="swiglu")
        jctx = jstrat.StrategyContext(B=2, S=8, d_model=D_PLAN, moe=jm,
                                      activation="swiglu")
        assert_same_plan(strategy.get_strategy(name).plan(ctx),
                         jstrat.get_strategy(name).plan(jctx))


def test_profile_detect_is_the_references():
    """Off a TPU the reference plans on one chiplet of the modeled array;
    so does the port, on the CPU and on the card."""
    assert dataclasses.asdict(autotune.HardwareProfile.detect()) == \
        dataclasses.asdict(jat.HardwareProfile.detect())


# ---------------------------------------------------------------------------
# the cost curves, == the reference's
# ---------------------------------------------------------------------------

SWEEP_LOADS = (None, "zipf")


def _load(E, kind):
    if kind is None:
        return None
    probs = workload.sample_expert_probs(E, np.random.default_rng(0),
                                         zipf_s=1.2)
    return tuple(float(v) for v in probs)


@pytest.mark.parametrize("load", SWEEP_LOADS)
@pytest.mark.parametrize("point", autotune.VALIDATION_SWEEP)
def test_mode_and_ep_costs_match_reference(point, load):
    B, S, E, de, P = point
    p, jp = _profiles(P)
    lv = _load(E, load)
    for mode in autotune.MODES:
        for M in (1, 2, 4):
            for wb in (None, 1):
                args = (mode, B, S, D_PLAN, E, de, 2, 1.25, 3, P)
                assert autotune.mode_cost(*args, p, M, 2, lv, wb) == \
                    jat.mode_cost(*args, jp, M, 2, lv, wb)
    args = (B, S, D_PLAN, E, de, 2, 1.25, 3, P)
    assert autotune.ep_cost(*args, p, 4, lv) == jat.ep_cost(*args, jp, 4, lv)
    assert autotune.fallback_plan(B, S, P, 4) == autotune.Plan(
        **dataclasses.asdict(jat.fallback_plan(B, S, P, 4)))


@pytest.mark.parametrize("level", ["analytic", "off"])
@pytest.mark.parametrize("point", autotune.VALIDATION_SWEEP)
def test_plan_moe_matches_reference(point, level):
    B, S, E, de, P = point
    p, jp = _profiles(P)
    moe, jm = _moes(num_experts=E, top_k=2, d_expert=de, micro_slices=4)
    for act, dtype_bytes, wb in (("swiglu", 2, None), ("relu2", 4, None),
                                 ("swiglu", 2, 1)):
        plan = autotune.plan_moe(B, S, D_PLAN, moe, act, P, profile=p,
                                 level=level, dtype_bytes=dtype_bytes,
                                 weight_bytes=wb)
        jplan = jat.plan_moe(B, S, D_PLAN, jm, act, P, profile=jp,
                             level=level, dtype_bytes=dtype_bytes,
                             weight_bytes=wb)
        assert_same_plan(plan, jplan)
        if level == "off":
            assert plan.kernel_opts() == {}


def test_plan_moe_on_the_tpu_profile():
    """The reference's other profile (TPU constants, an input here only)."""
    jp = jat.HardwareProfile.from_tpu()
    p = autotune.HardwareProfile(**dataclasses.asdict(jp))
    moe, jm = _moes(num_experts=16, top_k=2, d_expert=512, micro_slices=4)
    for (B, S) in ((1, 1), (4, 16), (2, 1024), (512, 1)):
        assert_same_plan(
            autotune.plan_moe(B, S, D_PLAN, moe, "swiglu", 4, profile=p),
            jat.plan_moe(B, S, D_PLAN, jm, "swiglu", 4, profile=jp))


def test_mode_ranking_agrees_with_simulator():
    """The port's plans choose the mode its own simulator ranks first on
    at least 80% of the reference's sweep, as the reference's do."""
    agree, rows = 0, []
    for (B, S, E, de, P) in autotune.VALIDATION_SWEEP:
        p, _ = _profiles(P)
        moe, _ = _moes(num_experts=E, top_k=2, d_expert=de, micro_slices=4)
        plan = autotune.plan_moe(B, S, D_PLAN, moe, "swiglu", P, profile=p,
                                 level="analytic")
        sim = sim_modes.rank_modes(_hw(P), hw.ModelSpec("s", D_PLAN, de, E,
                                                        2), B * S, B=B, S=S)
        best = min(sim, key=sim.get)
        agree += plan.mode == best
        rows.append((B, S, E, de, P, plan.mode, best))
    assert agree / len(autotune.VALIDATION_SWEEP) >= 0.8, rows


def test_sweep_exercises_all_three_modes():
    winners = set()
    for (B, S, E, de, P) in autotune.VALIDATION_SWEEP:
        sim = sim_modes.rank_modes(_hw(P), hw.ModelSpec("s", D_PLAN, de, E,
                                                        2), B * S, B=B, S=S)
        winners.add(min(sim, key=sim.get))
    assert winners == set(autotune.MODES)


def test_infeasible_modes_never_selected():
    p, _ = _profiles(4)
    moe, _ = _moes(num_experts=16, top_k=2, d_expert=512, micro_slices=4)
    # S = 3 < P and B * S % P != 0: only slice lowers
    plan = autotune.plan_moe(5, 3, D_PLAN, moe, "swiglu", 4, profile=p,
                             level="analytic")
    assert plan.mode == "slice"
    with pytest.raises(ValueError):
        autotune.plan_moe(5, 3, D_PLAN, moe, "swiglu", 4, profile=p,
                          mode="stream")


def test_level_off_matches_legacy_heuristic():
    for (B, S, E, de, P) in autotune.VALIDATION_SWEEP:
        moe, _ = _moes(num_experts=E, top_k=2, d_expert=de, micro_slices=4)
        plan = autotune.plan_moe(B, S, D_PLAN, moe, "swiglu", P, level="off")
        legacy = "stream" if S % P == 0 and S >= P else \
            "index" if (B * S) % P == 0 else "slice"
        assert (plan.mode, plan.micro_slices, plan.source) == \
            (legacy, moe.micro_slices, "fallback")
        assert plan.kernel_opts() == {}


@pytest.mark.parametrize("mode", autotune.MODES)
def test_forced_mode_plans(mode):
    p, jp = _profiles(4)
    moe, jm = _moes(num_experts=8, top_k=2, d_expert=64, micro_slices=4)
    plan = autotune.plan_moe(2, 16, D_PLAN, moe, "swiglu", 4, profile=p,
                             mode=mode)
    assert (plan.mode, plan.source) == (mode, "forced")
    assert_same_plan(plan, jat.plan_moe(2, 16, D_PLAN, jm, "swiglu", 4,
                                        profile=jp, mode=mode))


def test_plan_tiles_from_the_hopper_planner():
    """Given a card profile, the plan's tiles are the Hopper planner's for
    the winning plan's kernel shape: (E, C of the local tokens, d,
    d_expert / (P M))."""
    card = autotune.CardProfile.h100_sxm()
    moe, _ = _moes(num_experts=32, top_k=8, d_expert=512, micro_slices=2)
    plan = autotune.plan_moe(8, 64, 1024, moe, "swiglu", 8, card=card,
                             level="analytic")
    T_loc = 8 * 64 // 8 if plan.mode != "slice" else 8 * 64
    m = 512 // 8 // (plan.micro_slices if plan.mode != "slice" else 1)
    want = autotune.kernel_opts_for(32, moe.capacity_rows(T_loc), 1024, m,
                                    "swiglu", level="analytic", profile=card)
    assert plan.kernel_opts() == want and plan.tiles is not None


# ---------------------------------------------------------------------------
# the cross-family planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", strategy.FAMILY_SWEEP)
def test_family_costs_match_reference(point):
    B, S, E, de, P = point
    p, jp = _profiles(P)
    moe, jm = _moes(num_experts=E, top_k=2, d_expert=de)
    costs = strategy.family_costs(B, S, D_PLAN, moe, "swiglu", P, profile=p)
    assert costs == jstrat.family_costs(B, S, D_PLAN, jm, "swiglu", P,
                                        profile=jp)
    assert strategy.pick_family(costs) == jstrat.pick_family(costs)
    assert_same_plan(
        strategy.plan_family(B, S, D_PLAN, moe, "swiglu", P, profile=p),
        jstrat.plan_family(B, S, D_PLAN, jm, "swiglu", P, profile=jp))


def test_family_ranking_agrees_with_simulator():
    agree, rows = 0, []
    for (B, S, E, de, P) in strategy.FAMILY_SWEEP:
        p, _ = _profiles(P)
        moe, _ = _moes(num_experts=E, top_k=2, d_expert=de)
        chosen = strategy.pick_family(strategy.family_costs(
            B, S, D_PLAN, moe, "swiglu", P, profile=p))
        sim = sim_modes.rank_families(_hw(P), hw.ModelSpec("s", D_PLAN, de,
                                                           E, 2),
                                      B * S, B=B, S=S)
        best = min((f for f in FAMILIES if f in sim), key=lambda f: sim[f])
        agree += chosen == best
        rows.append((B, S, E, de, P, chosen, best))
    assert agree / len(strategy.FAMILY_SWEEP) >= 0.8, rows


def test_family_sweep_exercises_all_families():
    winners = set()
    for (B, S, E, de, P) in strategy.FAMILY_SWEEP:
        sim = sim_modes.rank_families(_hw(P), hw.ModelSpec("s", D_PLAN, de,
                                                           E, 2),
                                      B * S, B=B, S=S)
        assert "hybrid" not in sim
        winners.add(min((f for f in FAMILIES if f in sim),
                        key=lambda f: sim[f]))
    assert winners == set(strategy.BASE_FAMILIES)


def test_plan_family_off_level_routes_through_registry():
    moe, jm = _moes(num_experts=8, top_k=2, d_expert=32, capacity_factor=4.0)
    plan = strategy.plan_family(4, 16, D_PLAN, moe, "swiglu", 4, level="off")
    assert (plan.family, plan.source, plan.mode) == \
        ("fse_dp", "fallback", "stream")
    assert_same_plan(plan, jstrat.plan_family(4, 16, D_PLAN, jm, "swiglu", 4,
                                              level="off"))
    assert strategy.plan_family(4, 16, D_PLAN, moe, "swiglu", 1).family == \
        "capacity"


def test_auto_plan_carries_family_breakdown():
    moe, jm = _moes(num_experts=16, top_k=2, d_expert=512)
    p, jp = _profiles(4)
    plan = strategy.get_strategy("auto").plan(StrategyContext(
        B=8, S=1, d_model=D_PLAN, moe=moe, activation="swiglu", P=4,
        profile=p))
    assert plan.family in FAMILIES
    assert plan.family in dict(plan.per_mode_s)
    assert plan.predicted_s > 0
    assert_same_plan(plan, jstrat.get_strategy("auto").plan(
        jstrat.StrategyContext(B=8, S=1, d_model=D_PLAN, moe=jm,
                               activation="swiglu", P=4, profile=jp)))


@pytest.mark.parametrize("name", ["fse_dp", "ep", "tp", "hybrid"])
def test_family_plans_at_p4_match_reference(name):
    moe, jm = _moes(num_experts=16, top_k=2, d_expert=512)
    p, jp = _profiles(4, ndp=name == "hybrid")
    for (B, S) in ((8, 1), (1, 64), (3, 1)):
        ctx = StrategyContext(B=B, S=S, d_model=D_PLAN, moe=moe,
                              activation="swiglu", P=4, profile=p)
        jctx = jstrat.StrategyContext(B=B, S=S, d_model=D_PLAN, moe=jm,
                                      activation="swiglu", P=4, profile=jp)
        assert_same_plan(strategy.get_strategy(name).plan(ctx),
                         jstrat.get_strategy(name).plan(jctx))


def test_hybrid_rank_agreement_on_sweep():
    """On NDP hardware the port's family costs (with Zipf loads) equal the
    reference's, and its winner agrees with its simulator on at least 80%
    of HYBRID_SWEEP, hybrid / ep / fse_dp each winning somewhere."""
    agree, rows, winners = 0, [], set()
    for (B, S, E, de, P, zs) in strategy.HYBRID_SWEEP:
        p, jp = _profiles(P, ndp=True)
        moe, jm = _moes(num_experts=E, top_k=2, d_expert=de)
        loads = None if zs <= 0 else workload.sample_expert_probs(
            E, np.random.default_rng(0), zipf_s=zs)
        lt = None if loads is None else tuple(float(v) for v in loads)
        costs = strategy.family_costs(B, S, D_PLAN, moe, "swiglu", P,
                                      profile=p, load=lt)
        assert costs == jstrat.family_costs(B, S, D_PLAN, jm, "swiglu", P,
                                            profile=jp, load=lt)
        assert "hybrid" in costs
        chosen = strategy.pick_family(costs)
        sim = sim_modes.rank_families(
            _hw(P, ndp=True), hw.ModelSpec("s", D_PLAN, de, E, 2), B * S,
            B=B, S=S, loads=loads)
        best = min((f for f in FAMILIES if f in sim), key=lambda f: sim[f])
        winners.add(best)
        agree += chosen == best
        rows.append((B, S, E, de, P, zs, chosen, best))
    assert agree / len(strategy.HYBRID_SWEEP) >= 0.8, rows
    assert {"hybrid", "ep", "fse_dp"} <= winners, rows


def test_ep_feasibility_rules():
    for args in ((8, 1, 16, 4), (1, 8, 16, 4), (3, 1, 16, 4), (8, 8, 12, 8),
                 (8, 8, 16, 1)):
        assert strategy.ep_feasible(*args) == jstrat.ep_feasible(*args)

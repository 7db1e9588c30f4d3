"""MoE execution strategies: one spec, one registry (port of
``repro.core.strategy``).

:class:`ExecutionSpec` keeps the reference's fields and JSON form, so it
reads ``examples/moe-spec.json``.  The registry holds every strategy the
reference registers: the single-device ``dense``, ``capacity`` and
``hybrid`` (two-tier hot/cold placement, bit for bit the ``capacity``
output), the distributed ``fse_dp`` (the paper's expert streaming,
``core.fse_dp``), ``ep`` and ``tp`` (``core.baselines``), and ``auto``,
which scores the families' cost curves (:func:`family_costs`) and runs
the winner.  Each plans from a :class:`StrategyContext` and executes on
the mesh of ``parallel.meshctx``; with no model axis of size > 1 the
distributed four run ``capacity``, as the reference's do.  The spec's
scope enters its autotune level (``core.autotune.use_autotune``), then
its kernels, sorted dispatch and weight-dtype toggles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import functools
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.configs.base import MoEConfig
from repro_torch.core import autotune
from repro_torch.core.autotune import HardwareProfile, Plan
from repro_torch.kernels import quant

PHASES = ("train", "prefill", "decode")

# cross-family candidates of the reference's ``auto`` planner, in
# tie-break order; ``hybrid`` joins only on a profile with a near-memory
# tier (``sim.modes.rank_families`` mirrors this)
BASE_FAMILIES = ("fse_dp", "ep", "tp")
FAMILIES = BASE_FAMILIES + ("hybrid",)

# (B, S, E, d_expert, P) cross-family validation sweep, as the
# reference's: tiny-token shapes where TP is the only cheap dataflow,
# decode shapes where EP's token all-to-all beats moving weights, and
# prefill shapes with E % P != 0 where FSE-DP wins.  Each family wins at
# least once.
FAMILY_SWEEP: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 1, 16, 512, 4), (1, 2, 64, 256, 8), (2, 1, 16, 768, 4),
    (8, 1, 16, 512, 4), (32, 1, 16, 512, 4), (16, 1, 8, 1024, 2),
    (512, 1, 32, 256, 8), (1024, 2, 64, 256, 8), (4, 16, 8, 256, 4),
    (1, 128, 16, 512, 4),
    (4, 512, 12, 512, 8), (1, 512, 12, 768, 8), (2, 1024, 18, 512, 4),
    (2, 2048, 18, 768, 4),
)

# (B, S, E, d_expert, P, zipf_s) two-tier validation sweep on NDP
# hardware (``sim.hardware.with_ndp(scaled(...))``), as the reference's:
# hybrid wins low-batch decode, ep batch-heavy decode, fse_dp long
# prefill; zipf_s > 0 loads the race with a rank-permuted Zipf vector
# (``sim.workload``, seed 0).
HYBRID_SWEEP: Tuple[Tuple[int, int, int, int, int, float], ...] = (
    (1, 1, 64, 1408, 4, 1.2), (4, 1, 64, 1408, 4, 1.2),
    (2, 1, 128, 768, 4, 1.2), (32, 1, 16, 512, 4, 0.0),
    (1, 2, 64, 256, 8, 1.2), (16, 1, 8, 1024, 2, 0.0),
    (512, 1, 32, 256, 8, 0.0), (1024, 2, 64, 256, 8, 1.2),
    (4, 512, 16, 512, 4, 0.0),
    (2, 1024, 18, 512, 4, 0.0), (2, 2048, 18, 768, 4, 1.2),
)


def default_hot(E: int) -> int:
    """Fast-tier expert count when nothing better is known: the top
    quartile of experts by load (at least 1), the static top-N baseline
    the dynamic EMA repartition is measured against."""
    return max(1, E // 4)


def ep_feasible(B: int, S: int, E: int, P: int) -> bool:
    """EP lowers when experts split evenly and tokens can seq- or
    batch-shard over the model axis."""
    return P > 1 and E % P == 0 and (S % P == 0 or B % P == 0)


def _freeze_overrides(overrides) -> Tuple[Tuple[int, str], ...]:
    if not overrides:
        return ()
    items = overrides.items() if isinstance(overrides, dict) else tuple(overrides)
    return tuple(sorted((int(k), str(v)) for k, v in items))


@dataclass(frozen=True)
class ExecutionSpec:
    """How MoE layers execute.  Resolution at a call site:
    ``layer_overrides[layer]`` > per-phase field > ``strategy``."""

    strategy: str = "auto"
    prefill: Optional[str] = None
    decode: Optional[str] = None
    train: Optional[str] = None
    layer_overrides: Tuple[Tuple[int, str], ...] = ()
    autotune: Optional[str] = None          # off | analytic | measured
    schedule: Optional[str] = None          # static | dynamic (None=static)
    use_kernels: Optional[bool] = None      # None = ambient kernels toggle
    sorted_dispatch: Optional[bool] = None
    weight_dtype: Optional[str] = None      # fp32 | bf16 | int8 | fp8

    def __post_init__(self):
        object.__setattr__(self, "layer_overrides",
                           _freeze_overrides(self.layer_overrides))
        if self.autotune not in (None, "off", "analytic", "measured"):
            raise ValueError(f"unknown autotune level {self.autotune!r}")
        if self.schedule not in (None, "static", "dynamic"):
            raise ValueError(f"unknown schedule policy {self.schedule!r} "
                             f"(want 'static' or 'dynamic')")
        quant.check_weight_dtype(self.weight_dtype)

    def resolve(self, phase: Optional[str] = None,
                layer: Optional[int] = None) -> str:
        if layer is not None:
            for lyr, name in self.layer_overrides:
                if lyr == layer:
                    return name
        if phase is not None:
            if phase not in PHASES:
                raise ValueError(f"unknown phase {phase!r} (want {PHASES})")
            override = getattr(self, phase)
            if override:
                return override
        return self.strategy

    def strategies_used(self) -> Tuple[str, ...]:
        names = {self.strategy}
        names |= {getattr(self, p) for p in PHASES if getattr(self, p)}
        names |= {name for _, name in self.layer_overrides}
        return tuple(sorted(names))

    def validate(self) -> "ExecutionSpec":
        """Raise if a referenced strategy is not available."""
        for name in self.strategies_used():
            get_strategy(name)
        return self

    @contextlib.contextmanager
    def scope(self):
        """Apply the spec's autotune, kernels, dispatch and weight-dtype
        toggles."""
        with contextlib.ExitStack() as stack:
            if self.autotune is not None:
                stack.enter_context(autotune.use_autotune(self.autotune))
            if self.use_kernels is not None:
                from repro_torch.kernels import ops as kops
                stack.enter_context(kops.use_kernels(self.use_kernels))
            if self.sorted_dispatch is not None:
                from repro_torch.models.moe import use_sorted_dispatch
                stack.enter_context(use_sorted_dispatch(self.sorted_dispatch))
            if self.weight_dtype is not None:
                stack.enter_context(quant.use_weight_dtype(self.weight_dtype))
            yield self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"strategy": self.strategy}
        for p in PHASES:
            if getattr(self, p) is not None:
                out[p] = getattr(self, p)
        if self.layer_overrides:
            out["layer_overrides"] = {str(k): v for k, v in self.layer_overrides}
        for f in ("autotune", "schedule", "use_kernels", "sorted_dispatch",
                  "weight_dtype"):
            if getattr(self, f) is not None:
                out[f] = getattr(self, f)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExecutionSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ExecutionSpec fields {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "ExecutionSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def coerce(cls, value, default: str = "auto") -> "ExecutionSpec":
        if value is None:
            return cls(strategy=default)
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(strategy=value)
        if isinstance(value, dict):
            if "strategy" not in value:
                value = dict(value, strategy=default)
            return cls.from_dict(value)
        raise TypeError(f"cannot coerce {type(value).__name__} to ExecutionSpec")


@dataclass(frozen=True)
class StrategyContext:
    """Static shape and config facts a strategy needs to plan one call."""

    B: int
    S: int
    d_model: int
    moe: MoEConfig
    activation: str
    P: int = 1               # model-axis size
    dtype_bytes: int = 2     # activation bytes per element
    level: Optional[str] = None
    profile: Optional[HardwareProfile] = None
    load: Optional[Tuple[float, ...]] = None  # per-expert load shares
    weight_bytes: Optional[int] = None  # streamed expert-weight bytes/param
    #                                     (None = dtype_bytes)

    @classmethod
    def from_inputs(cls, x, moe: MoEConfig, activation: str,
                    axis: str = "model", *,
                    load: Optional[Tuple[float, ...]] = None
                    ) -> "StrategyContext":
        """From this model group's (B, S, d) rows (``core.fse_dp``'s
        layout), P from the active mesh's ``axis``; the streamed weight
        bytes are the ambient ``quant.weight_dtype``'s."""
        from repro_torch.parallel import meshctx
        B, S, d = x.shape
        return cls(B=int(B), S=int(S), d_model=int(d), moe=moe,
                   activation=activation, P=meshctx.model_axis_size(axis),
                   dtype_bytes=x.element_size(), load=load,
                   weight_bytes=quant.weight_bytes())


@runtime_checkable
class MoEStrategy(Protocol):
    """One pluggable execution family."""

    name: str

    def plan(self, ctx: StrategyContext) -> Plan:
        """The decision for one call (pure Python, memoizable)."""
        ...

    def execute(self, params, x, moe: MoEConfig, activation: str,
                plan: Optional[Plan] = None, *, axis: str = "model",
                routing=None, schedule=None, aux: bool = True):
        """x: (B, S, d), this model group's rows.  Returns ``(y, aux)``
        (aux None when ``aux`` is False).  ``routing`` pre-computes the
        route stage (single-device strategies only), ``schedule`` the
        schedule stage (``trajectory.Schedule``)."""
        ...


_REGISTRY: Dict[str, MoEStrategy] = {}


def register(name: str):
    """Class decorator: instantiate and register an execution strategy."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_strategy(name: str) -> MoEStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown MoE strategy {name!r}; "
                       f"registered: {available()}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def execute(name_or_spec, params, x, moe: MoEConfig, activation: str, *,
            plan: Optional[Plan] = None, axis: str = "model",
            phase: Optional[str] = None, layer: Optional[int] = None,
            routing=None, schedule=None):
    """Functional entry: one MoE layer under a strategy name or an
    :class:`ExecutionSpec` -> ``(y, aux)``.  With no ``schedule``, a spec
    whose ``schedule`` is ``"dynamic"`` derives the trajectory from each
    call's own routing."""
    from . import trajectory
    spec = ExecutionSpec.coerce(name_or_spec)
    name = spec.resolve(phase=phase, layer=layer)
    if schedule is None and spec.schedule == "dynamic":
        schedule = trajectory.DYNAMIC
    with spec.scope():
        return get_strategy(name).execute(params, x, moe, activation, plan,
                                          axis=axis, routing=routing,
                                          schedule=schedule)


_ENTRY_WARNED: set = set()


def warn_deprecated_entry(old: str, name: str) -> None:
    """One-shot DeprecationWarning for a legacy ``*_moe_3d`` entry point
    (``old``) whose strategy is ``name``."""
    if old in _ENTRY_WARNED:
        return
    _ENTRY_WARNED.add(old)
    warnings.warn(f"{old} is deprecated; use repro_torch.core.strategy."
                  f"execute({name!r}, ...) or moe_block(spec=...)",
                  DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# cross-family cost curves and the auto planner
# ---------------------------------------------------------------------------


def family_costs(B: int, S: int, d_model: int, moe: MoEConfig,
                 activation: str, P: int, *,
                 profile: Optional[HardwareProfile] = None,
                 dtype_bytes: int = 2,
                 load: Optional[Tuple[float, ...]] = None,
                 weight_bytes: Optional[int] = None) -> Dict[str, float]:
    """Predicted seconds per candidate family for one MoE layer.

    ``fse_dp`` is its best ring schedule (stream / index with their best
    micro-slices) and leaves the race when no ring layout lowers (its
    slice dataflow is ``tp``'s); ``ep`` races where it lowers; ``tp`` is
    the weights-stationary curve; ``hybrid`` joins on a profile with a
    near-memory tier.  ``load`` conditions every curve on a normalized
    per-expert load vector."""
    profile = profile or HardwareProfile.detect()
    n_mats = 3 if activation == "swiglu" else 2
    E, de = moe.num_experts, moe.d_expert
    k, cf = moe.top_k, moe.capacity_factor
    de_loc = max(1, de // P)
    out: Dict[str, float] = {}

    ring = [m for m in autotune.feasible_modes(B, S, P) if m != "slice"]
    if ring:
        out["fse_dp"] = min(
            autotune.mode_cost(m, B, S, d_model, E, de, k, cf, n_mats, P,
                               profile, M, dtype_bytes, load,
                               weight_bytes)["total_s"]
            for m in ring
            for M in autotune._micro_candidates(de_loc, moe.micro_slices))
    if ep_feasible(B, S, E, P):
        out["ep"] = autotune.ep_cost(B, S, d_model, E, de, k, cf, n_mats,
                                     P, profile, dtype_bytes, load,
                                     weight_bytes)["total_s"]
    out["tp"] = autotune.mode_cost("slice", B, S, d_model, E, de, k, cf,
                                   n_mats, P, profile, 1, dtype_bytes, load,
                                   weight_bytes)["total_s"]
    if profile.ndp_flops and profile.ndp_bw:
        out["hybrid"] = autotune.hybrid_cost(
            B, S, d_model, E, de, k, cf, n_mats, P, profile,
            dtype_bytes, load, weight_bytes)["total_s"]
    return out


def pick_family(costs: Dict[str, float]) -> str:
    """Argmin in FAMILIES order (ties go to the earlier family)."""
    return min((f for f in FAMILIES if f in costs), key=lambda f: costs[f])


@functools.lru_cache(maxsize=4096)
def _plan_family_cached(B: int, S: int, d_model: int, moe: MoEConfig,
                        activation: str, P: int,
                        profile: Optional[HardwareProfile],
                        dtype_bytes: int, level: str,
                        load: Optional[Tuple[float, ...]],
                        weight_bytes: Optional[int]) -> Plan:
    if P == 1:
        return Plan(mode="capacity", family="capacity", micro_slices=1,
                    source="fallback")
    if level == "off":
        return autotune.fallback_plan(B, S, P, moe.micro_slices)
    costs = family_costs(B, S, d_model, moe, activation, P,
                         profile=profile, dtype_bytes=dtype_bytes, load=load,
                         weight_bytes=weight_bytes)
    family = pick_family(costs)
    per_family = tuple(sorted((f, float(s)) for f, s in costs.items()))
    if family == "fse_dp":
        plan = autotune.plan_moe(B, S, d_model, moe, activation, P,
                                 profile=profile, dtype_bytes=dtype_bytes,
                                 level=level, load=load,
                                 weight_bytes=weight_bytes)
        return dataclasses.replace(plan, per_mode_s=plan.per_mode_s
                                   + per_family)
    if family == "hybrid":
        c = autotune.hybrid_cost(
            B, S, d_model, moe.num_experts, moe.d_expert, moe.top_k,
            moe.capacity_factor, 3 if activation == "swiglu" else 2, P,
            profile or HardwareProfile.detect(), dtype_bytes, load,
            weight_bytes)
        return Plan(mode="hybrid", family="hybrid", micro_slices=1,
                    predicted_s=costs["hybrid"], per_mode_s=per_family,
                    source="analytic", hot_experts=int(c["hot_n"]))
    return Plan(mode=family, family=family, micro_slices=1,
                predicted_s=costs[family], per_mode_s=per_family,
                source="analytic")


def plan_family(B: int, S: int, d_model: int, moe: MoEConfig,
                activation: str, P: int, *,
                profile: Optional[HardwareProfile] = None,
                dtype_bytes: int = 2,
                level: Optional[str] = None,
                load: Optional[Tuple[float, ...]] = None,
                weight_bytes: Optional[int] = None) -> Plan:
    """The winning family's Plan for one shape: EP and TP curves scored
    beside the FSE-DP ring modes; memoized."""
    level = level or autotune.autotune_level()
    if load is not None:
        load = tuple(float(v) for v in load)
    return _plan_family_cached(int(B), int(S), int(d_model), moe,
                               activation, int(P), profile,
                               int(dtype_bytes), level, load,
                               None if weight_bytes is None
                               else int(weight_bytes))


# ---------------------------------------------------------------------------
# the strategies
# ---------------------------------------------------------------------------


class _SingleDevice:
    """Global routing on one device: route (or accept the routing), then
    the dense, capacity or two-tier dataflow of ``models.moe``."""

    def plan(self, ctx: StrategyContext) -> Plan:
        return Plan(mode=self.name, family=self.name, micro_slices=1,
                    source="analytic")

    def route(self, params, x, moe, routing=None):
        from . import gating
        x2d = x.reshape(-1, x.shape[-1])
        if routing is None:
            routing = gating.route(params["router"], x2d, top_k=moe.top_k)
        return x2d, routing

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        """-> (y, the load-balance loss, or None when ``aux`` is False:
        the serving paths skip its kernels, as XLA drops them unused).
        Expert stacks stored split on ``axis`` (the mesh steps' layout)
        are gathered whole first."""
        from repro_torch.parallel import sharding
        from . import gating
        params = sharding.gather_experts(params, axis)
        x2d, routing = self.route(params, x, moe, routing)
        y = self.run(params, x2d, routing, moe, activation, schedule)
        return (y.reshape(x.shape),
                gating.aux_load_balance_loss(routing, moe.num_experts)
                if aux else None)


@register("dense")
class DenseStrategy(_SingleDevice):
    """Every expert on every token, masked combine (oracle)."""

    def run(self, params, x2d, routing, moe, activation, schedule):
        from repro_torch.models import moe as moe_mod
        return moe_mod.moe_dense(params, x2d, routing, activation,
                                 schedule=schedule)


@register("capacity")
class CapacityStrategy(_SingleDevice):
    """Switch-style capacity dispatch through the streamed_moe kernel."""

    def run(self, params, x2d, routing, moe, activation, schedule):
        from repro_torch.models import moe as moe_mod
        return moe_mod.moe_capacity(params, x2d, routing, moe, activation,
                                    schedule=schedule)


@register("fse_dp")
class FseDpStrategy:
    """The paper's expert streaming (the ring of ``core.fse_dp``)."""

    def plan(self, ctx: StrategyContext) -> Plan:
        if ctx.P == 1:
            return Plan(mode="capacity", family="capacity", micro_slices=1,
                        source="fallback")
        return autotune.plan_moe(ctx.B, ctx.S, ctx.d_model, ctx.moe,
                                 ctx.activation, ctx.P,
                                 profile=ctx.profile,
                                 dtype_bytes=ctx.dtype_bytes,
                                 level=ctx.level, load=ctx.load,
                                 weight_bytes=ctx.weight_bytes)

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        from . import fse_dp
        return fse_dp.moe_fse_dp(params, x, moe, activation, axis=axis,
                                 plan=plan, routing=routing,
                                 schedule=schedule, aux=aux)


@register("ep")
class EpStrategy:
    """Expert parallelism: all-to-all token exchange to expert owners."""

    def plan(self, ctx: StrategyContext) -> Plan:
        if ctx.P == 1 or not ep_feasible(ctx.B, ctx.S,
                                         ctx.moe.num_experts, ctx.P):
            return get_strategy("fse_dp").plan(ctx)
        profile = ctx.profile or HardwareProfile.detect()
        n_mats = 3 if ctx.activation == "swiglu" else 2
        c = autotune.ep_cost(ctx.B, ctx.S, ctx.d_model,
                             ctx.moe.num_experts, ctx.moe.d_expert,
                             ctx.moe.top_k, ctx.moe.capacity_factor,
                             n_mats, ctx.P, profile, ctx.dtype_bytes,
                             ctx.load, ctx.weight_bytes)
        return Plan(mode="ep", family="ep", micro_slices=1,
                    predicted_s=c["total_s"], source="analytic")

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        from . import baselines
        return baselines.moe_ep(params, x, moe, activation, axis=axis,
                                routing=routing, schedule=schedule, aux=aux)


@register("tp")
class TpStrategy:
    """Tensor parallelism: d_expert sliced, tokens replicated, psum."""

    def plan(self, ctx: StrategyContext) -> Plan:
        if ctx.P == 1:
            return get_strategy("fse_dp").plan(ctx)
        profile = ctx.profile or HardwareProfile.detect()
        n_mats = 3 if ctx.activation == "swiglu" else 2
        c = autotune.mode_cost("slice", ctx.B, ctx.S, ctx.d_model,
                               ctx.moe.num_experts, ctx.moe.d_expert,
                               ctx.moe.top_k, ctx.moe.capacity_factor,
                               n_mats, ctx.P, profile, 1, ctx.dtype_bytes,
                               ctx.load, ctx.weight_bytes)
        return Plan(mode="tp", family="tp", micro_slices=1,
                    predicted_s=c["total_s"], source="analytic")

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        from . import baselines
        return baselines.moe_tp(params, x, moe, activation, axis=axis,
                                routing=routing, schedule=schedule, aux=aux)


@register("hybrid")
class HybridStrategy(_SingleDevice):
    """Two-tier hot/cold placement: hot experts stream through the fast
    chiplet array, cold experts execute in place on the near-memory tier
    (``HardwareConfig.ndp``); the layer finishes at the slower tier.  The
    split is placement only: execution cuts the load-ordered expert axis
    into a hot prefix and a cold tail, bit for bit the ``capacity``
    output.  Under a model axis of size > 1 the hot tier's flow is the
    FSE-DP ring, so it runs ``fse_dp``, as the reference does."""

    def plan(self, ctx: StrategyContext) -> Plan:
        profile = ctx.profile or HardwareProfile.detect()
        E = ctx.moe.num_experts
        if not (profile.ndp_flops and profile.ndp_bw):
            # homogeneous hardware: placement-only plan, static top-N
            return Plan(mode="hybrid", family="hybrid", micro_slices=1,
                        source="fallback", hot_experts=default_hot(E))
        n_mats = 3 if ctx.activation == "swiglu" else 2
        c = autotune.hybrid_cost(ctx.B, ctx.S, ctx.d_model, E,
                                 ctx.moe.d_expert, ctx.moe.top_k,
                                 ctx.moe.capacity_factor, n_mats, ctx.P,
                                 profile, ctx.dtype_bytes, ctx.load,
                                 ctx.weight_bytes)
        return Plan(mode="hybrid", family="hybrid", micro_slices=1,
                    predicted_s=c["total_s"], source="analytic",
                    hot_experts=int(c["hot_n"]))

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        from repro_torch.parallel import meshctx
        if meshctx.model_axis_size(axis) > 1:
            return get_strategy("fse_dp").execute(
                params, x, moe, activation, None, axis=axis,
                routing=routing, schedule=schedule, aux=aux)
        return super().execute(params, x, moe, activation, plan, axis=axis,
                               routing=routing, schedule=schedule, aux=aux)

    def run(self, params, x2d, routing, moe, activation, schedule):
        """H from the schedule's plan (the engine's EMA width on the eager
        path), else ``default_hot(E)``."""
        from repro_torch.models import moe as moe_mod
        plan = None if schedule is None else schedule.plan
        H = plan.hot_experts if plan is not None \
            and plan.hot_experts is not None \
            else default_hot(moe.num_experts)
        return moe_mod.moe_hybrid(params, x2d, routing, moe, activation,
                                  hot_experts=H, schedule=schedule)


@register("auto")
class AutoStrategy:
    """Cross-family planner: the EP and TP cost curves scored beside the
    FSE-DP ring modes; runs the winning family's strategy."""

    def plan(self, ctx: StrategyContext) -> Plan:
        return plan_family(ctx.B, ctx.S, ctx.d_model, ctx.moe,
                           ctx.activation, ctx.P, profile=ctx.profile,
                           dtype_bytes=ctx.dtype_bytes, level=ctx.level,
                           load=ctx.load, weight_bytes=ctx.weight_bytes)

    def execute(self, params, x, moe, activation, plan=None, *,
                axis="model", routing=None, schedule=None, aux=True):
        load = None if schedule is None else schedule.load
        ctx = StrategyContext.from_inputs(x, moe, activation, axis, load=load)
        if ctx.P == 1:
            return get_strategy("capacity").execute(
                params, x, moe, activation, axis=axis, routing=routing,
                schedule=schedule, aux=aux)
        plan = plan or (schedule.plan if schedule is not None
                        and schedule.plan is not None else None) \
            or self.plan(ctx)
        inner = plan if plan.family == "fse_dp" else None
        return get_strategy(plan.family).execute(
            params, x, moe, activation, inner, axis=axis, routing=routing,
            schedule=schedule, aux=aux)

"""MoE execution strategies: one spec, one registry (port of the
single-device part of ``repro.core.strategy``).

:class:`ExecutionSpec` keeps the reference's fields and JSON form, so it
reads ``examples/moe-spec.json``.  The registry holds the single-device
strategies ``dense``, ``capacity`` and ``hybrid`` (two-tier hot/cold
placement: a hot prefix of the load-ordered experts on the fast array, a
cold tail near memory, bit for bit the ``capacity`` output), which plans
from a :class:`StrategyContext`.  The distributed reference strategies
are known names that raise ``NotImplementedError`` naming the ROADMAP
step that ports them.  The spec's scope enters its autotune level (the
Hopper tile planner's, ``core.autotune.use_autotune``), then its kernels,
sorted dispatch and weight-dtype toggles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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


def default_hot(E: int) -> int:
    """Fast-tier expert count when nothing better is known: the top
    quartile of experts by load (at least 1), the static top-N baseline
    the dynamic EMA repartition is measured against."""
    return max(1, E // 4)


def ep_feasible(B: int, S: int, E: int, P: int) -> bool:
    """EP lowers when experts split evenly and tokens can seq- or
    batch-shard over the model axis."""
    return P > 1 and E % P == 0 and (S % P == 0 or B % P == 0)


# reference strategies not ported yet -> the ROADMAP step that ports them
UNPORTED = {
    "fse_dp": "ROADMAP A.14 (distributed families)",
    "ep": "ROADMAP A.14 (distributed families)",
    "tp": "ROADMAP A.14 (distributed families)",
    "auto": "ROADMAP A.14 (distributed families)",
}


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
        """From a (B, S, d) tensor on one device (``P`` = 1: the model
        mesh comes with ROADMAP A.14); the streamed weight bytes are the
        ambient ``quant.weight_dtype``'s."""
        B, S, d = x.shape
        return cls(B=int(B), S=int(S), d_model=int(d), moe=moe,
                   activation=activation, P=1,
                   dtype_bytes=x.element_size(), load=load,
                   weight_bytes=quant.weight_bytes())


_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    """Class decorator: instantiate and register an execution strategy."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_strategy(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"MoE strategy {name!r} is not ported yet: {UNPORTED[name]}")
    raise KeyError(f"unknown MoE strategy {name!r}; registered: {available()}")


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


class _SingleDevice:
    """Global routing on one device: route (or accept the routing), then
    the dense, capacity or two-tier dataflow of ``models.moe``."""

    def route(self, params, x, moe, routing=None):
        from . import gating
        x2d = x.reshape(-1, x.shape[-1])
        if routing is None:
            routing = gating.route(params["router"], x2d, top_k=moe.top_k)
        return x2d, routing

    def execute(self, params, x, moe, activation, *, routing=None,
                schedule=None, aux=True):
        """-> (y, the load-balance loss, or None when ``aux`` is False:
        the serving paths skip its kernels, as XLA drops them unused)."""
        from . import gating
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


@register("hybrid")
class HybridStrategy(_SingleDevice):
    """Two-tier hot/cold placement: hot experts stream through the fast
    chiplet array, cold experts execute in place on the near-memory tier
    (``HardwareConfig.ndp``); the layer finishes at the slower tier.  The
    split is placement only: execution cuts the load-ordered expert axis
    into a hot prefix and a cold tail, bit for bit the ``capacity``
    output.  (The reference delegates to ``fse_dp`` under a model mesh;
    that branch comes with ROADMAP A.14.)"""

    def plan(self, ctx: StrategyContext) -> Plan:
        # the modeled chiplet array, as the reference plans off a TPU
        profile = ctx.profile or HardwareProfile.from_chiplet()
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

"""MoE execution strategies: one spec, one registry (port of the
single-device part of ``repro.core.strategy``).

:class:`ExecutionSpec` keeps the reference's fields and JSON form, so it
reads ``examples/moe-spec.json``.  The registry holds the single-device
strategies ``dense`` and ``capacity``.  The other reference strategies
are known names that raise ``NotImplementedError`` naming the ROADMAP
step that ports them, as does ``sorted_dispatch=True``.  The spec's
``autotune`` level is carried and ignored: the Hopper tile planner is
not ported yet (the kernel's tiles are fixed).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from repro_torch.kernels import quant

PHASES = ("train", "prefill", "decode")

# reference strategies not ported yet -> the ROADMAP step that ports them
UNPORTED = {
    "hybrid": "ROADMAP A.11 (hybrid, sorted dispatch, resident tier)",
    "fse_dp": "ROADMAP A.14 (distributed families)",
    "ep": "ROADMAP A.14 (distributed families)",
    "tp": "ROADMAP A.14 (distributed families)",
    "auto": "ROADMAP A.14 (distributed families)",
}
SORTED_DISPATCH_STEP = UNPORTED["hybrid"]


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
        """Raise if a referenced strategy or option is not available."""
        for name in self.strategies_used():
            get_strategy(name)
        if self.sorted_dispatch:
            raise NotImplementedError(
                f"sorted_dispatch is not ported yet: {SORTED_DISPATCH_STEP}")
        return self

    @contextlib.contextmanager
    def scope(self):
        """Apply the spec's kernels and weight-dtype toggles."""
        if self.sorted_dispatch:
            raise NotImplementedError(
                f"sorted_dispatch is not ported yet: {SORTED_DISPATCH_STEP}")
        with contextlib.ExitStack() as stack:
            if self.use_kernels is not None:
                from repro_torch.kernels import ops as kops
                stack.enter_context(kops.use_kernels(self.use_kernels))
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
    the dense or capacity dataflow of ``models.moe``."""

    def route(self, params, x, moe, routing=None):
        from . import gating
        x2d = x.reshape(-1, x.shape[-1])
        if routing is None:
            routing = gating.route(params["router"], x2d, top_k=moe.top_k)
        return x2d, routing

    def execute(self, params, x, moe, activation, *, routing=None,
                schedule=None):
        from . import gating
        x2d, routing = self.route(params, x, moe, routing)
        y = self.run(params, x2d, routing, moe, activation, schedule)
        return (y.reshape(x.shape),
                gating.aux_load_balance_loss(routing, moe.num_experts))


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

"""Expert-trajectory scheduling (port of ``repro.core.trajectory``).

A ``static`` schedule is the identity trajectory.  A ``dynamic`` one
orders experts by the paired-load policy, from the engine's EMA of
observed counts (:class:`LoadTracker`) or from the call's own routing
(:func:`traced_order`).  The trajectory permutes the expert axis of the
dispatched (E, C, d) rows and the weight stacks, and is undone before
the combine, so it changes execution order and never values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .policies import expert_pairs, paired_load_order

SCHEDULE_POLICIES = ("static", "dynamic")


@dataclass(frozen=True)
class Schedule:
    """One expert-trajectory decision for one MoE layer call.

    ``order`` is a host tuple of expert ids, a tensor, or ``None``
    (derive from the call's own counts when dynamic).  ``plan`` is
    carried opaquely: the cost-model plan is not ported yet."""

    policy: str = "static"
    order: Optional[Tuple[int, ...]] = None
    pairs: Tuple[Tuple[int, Optional[int]], ...] = ()
    load: Optional[Tuple[float, ...]] = None
    plan: Optional[Any] = None
    predicted_s: float = 0.0

    def __post_init__(self):
        if self.policy not in SCHEDULE_POLICIES:
            raise ValueError(f"unknown schedule policy {self.policy!r} "
                             f"(want {SCHEDULE_POLICIES})")
        if self.order is not None and not isinstance(self.order, torch.Tensor):
            object.__setattr__(self, "order",
                               tuple(int(e) for e in self.order))

    @property
    def dynamic(self) -> bool:
        return self.policy == "dynamic"


DYNAMIC = Schedule(policy="dynamic")


def normalized_load(counts: Sequence[float]) -> Optional[Tuple[float, ...]]:
    c = np.asarray(counts, np.float64)
    tot = float(c.sum())
    if tot <= 0:
        return None
    return tuple(float(v) for v in c / tot)


def build_schedule(counts: Optional[Sequence[int]] = None, *,
                   policy: str = "dynamic") -> Schedule:
    """Host-side schedule from observed (or EMA) expert counts."""
    if policy == "static" or counts is None:
        return Schedule(policy="static")
    return Schedule(policy="dynamic",
                    order=tuple(paired_load_order(counts)),
                    pairs=tuple(expert_pairs(counts)),
                    load=normalized_load(counts))


@dataclass
class LoadTracker:
    """EMA of per-expert activation counts (one per MoE layer)."""

    num_experts: int
    decay: float = 0.8
    steps: int = 0
    ema: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.ema is None:
            self.ema = np.zeros((self.num_experts,), np.float64)

    def update(self, counts: Sequence[int]) -> np.ndarray:
        c = np.asarray(counts, np.float64)
        if self.steps == 0:
            self.ema = c.copy()
        else:
            self.ema = self.decay * self.ema + (1.0 - self.decay) * c
        self.steps += 1
        return self.ema

    def schedule(self) -> Schedule:
        """A dynamic Schedule from the EMA (derived in-call before any
        observation)."""
        if self.steps == 0:
            return Schedule(policy="dynamic")
        return build_schedule(self.ema, policy="dynamic")


def traced_order(counts: torch.Tensor) -> torch.Tensor:
    """Tensor analogue of ``paired_load_order``: order[2i] is the i-th
    hottest expert (stable descending sort), order[2i+1] the i-th
    coldest; idle experts interleave instead of trailing."""
    E = counts.shape[0]
    desc = torch.sort(-counts.to(torch.int64), stable=True).indices
    half = (E + 1) // 2
    order = torch.empty((E,), dtype=torch.int64, device=counts.device)
    order[0::2] = desc[:half]
    order[1::2] = desc[half:].flip(0)
    return order


def resolve_order(schedule: Optional[Schedule],
                  counts_fn: Callable[[], torch.Tensor], device=None):
    """``None`` (static), the schedule's host order as a tensor, or the
    order derived from this call's counts (``counts_fn``)."""
    if schedule is None or not schedule.dynamic:
        return None
    if schedule.order is not None:
        return torch.as_tensor(schedule.order, dtype=torch.int64,
                               device=device)
    return traced_order(counts_fn())


def apply_order(order, *arrays):
    """Reindex the leading (expert) axis into trajectory order."""
    return tuple(None if a is None else a.index_select(0, order)
                 for a in arrays)


def restore_order(order, ye):
    """Undo :func:`apply_order` on the expert outputs before the combine."""
    return ye.index_select(0, torch.argsort(order))

"""Scheduling policies from the paper (§IV-A, §V) — the port's own copy
of ``repro.core.policies`` (host-side, plain ints / numpy): the
paired-load expert order and Algorithm-2 token buffering."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def paired_load_order(token_counts: Sequence[int]) -> List[int]:
    """Experts sorted by activation count with opposite ends paired:
    [hot1, cold1, hot2, cold2, ...], idle experts (zero tokens) last."""
    counts = np.asarray(token_counts)
    desc = np.argsort(-counts, kind="stable")
    busy = counts[desc] > 0
    active, idle = desc[busy], desc[~busy]
    # a0, a(n-1), a1, a(n-2), ...: the first half at the even places, the
    # second half reversed at the odd ones (the engine calls this at every
    # MoE boundary, so it is one pass of numpy, not a Python loop)
    order = np.empty_like(active)
    half = (len(active) + 1) // 2
    order[0::2] = active[:half]
    order[1::2] = active[half:][::-1]
    return order.tolist() + idle.tolist()


def expert_pairs(token_counts: Sequence[int]) -> List[tuple]:
    """(hot, cold) pairs of the paired-load order; the odd one out pairs
    with ``None``."""
    counts = np.asarray(token_counts)
    order = [e for e in paired_load_order(token_counts) if counts[e] > 0]
    return [(order[i], order[i + 1] if i + 1 < len(order) else None)
            for i in range(0, len(order), 2)]


@dataclass
class QoSState:
    """Per-request token-buffering bookkeeping (Algorithm 2)."""
    timer: int = 0
    fw_count: int = 0
    deferrals: int = 0


@dataclass
class TokenBufferPolicy:
    """Algorithm 2: defer a request at an MoE boundary when it activates a
    cold expert (n_e < theta_min) and has QoS credit; ``n_threshold``
    forward passes earn one credit (``from_slack``: ceil(1/slack))."""
    theta_min: int = 4
    n_threshold: int = 10
    states: Dict[str, QoSState] = field(default_factory=dict)

    @classmethod
    def from_slack(cls, slack: float, theta_min: int = 4) -> "TokenBufferPolicy":
        if slack <= 0:
            return cls(theta_min=theta_min, n_threshold=1 << 30)
        return cls(theta_min=theta_min,
                   n_threshold=max(1, int(np.ceil(1.0 / slack))))

    def state(self, rid: str) -> QoSState:
        return self.states.setdefault(rid, QoSState())

    def on_forward_pass(self, rid: str) -> None:
        st = self.state(rid)
        st.fw_count += 1
        if st.fw_count >= self.n_threshold:
            st.timer += 1
            st.fw_count = 0

    def should_defer(self, rid: str, activated_experts: Sequence[int],
                     expert_token_counts: Sequence[int]) -> bool:
        st = self.state(rid)
        if st.timer <= 0:
            return False
        counts = np.asarray(expert_token_counts)
        if any(counts[e] < self.theta_min for e in activated_experts):
            st.timer -= 1
            st.deferrals += 1
            return True
        return False

    def drop(self, rid: str) -> None:
        self.states.pop(rid, None)

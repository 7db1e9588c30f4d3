"""Request splitter and Zipf sampler (port of what ``serving.traffic``
draws from in ``repro.sim.workload``), so the port's request streams are
the reference's, byte for byte."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Request:
    rid: str
    num_tokens: int
    home_chiplet: int
    affinity_seed: int                     # per-request expert affinity


def sample_expert_probs(E: int, rng: np.random.Generator,
                        zipf_s: float = 1.1) -> np.ndarray:
    """Zipf-ranked probabilities with random rank permutation."""
    ranks = np.arange(1, E + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    p /= p.sum()
    return p[rng.permutation(E)]


def make_requests(tokens_per_iter: int, num_chiplets: int, seed: int,
                  avg_request_tokens: int | None = None) -> List[Request]:
    """Split an iteration's token budget into mixed prefill/decode requests."""
    rng = np.random.default_rng(seed)
    if avg_request_tokens is None:
        avg_request_tokens = max(1, tokens_per_iter // 8)
    reqs: List[Request] = []
    remaining = tokens_per_iter
    i = 0
    while remaining > 0:
        n = int(min(remaining, max(1, rng.poisson(avg_request_tokens))))
        reqs.append(Request(rid=f"r{seed}_{i}", num_tokens=n,
                            home_chiplet=i % num_chiplets,
                            affinity_seed=int(rng.integers(1 << 30))))
        remaining -= n
        i += 1
    return reqs

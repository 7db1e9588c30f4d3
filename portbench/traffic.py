"""The benchmark's one traffic generator (numpy only), driven by the
parameters of a traffic mix (``mixes/<traffic>.json``).

A frozen copy of the port's generator (``repro_torch.serving.traffic``):
each request draws its prompt from a private Zipf affinity over the
vocabulary (a Zipf-ranked, randomly permuted distribution, the sampler
of ``repro_torch.sim.workload.sample_expert_probs``), Zipf-shared
system prompts may go in front (``prefix``), and the arrival rate may
follow a sinusoidal cycle (``diurnal``).  Unlike the port's copy its
clock is seconds, and its sizes are stratified: a pool of ``pool``
prompt lengths, output lengths and arrival gaps is taken at the
quantiles ``(i + 0.5) / pool`` of their distributions, and permuted
by the fixed ``ORDER_SEED``; the tokens come from the run's seed.  So
every seed offers the same work at the same times and differs in what
the model reads: an open-loop cell replays one arrival schedule, and
runs of one cell differ by the system, not by how a seed happened to
order the queue (near a server's knee the order of bursts alone moves a
latency tail by half).

Parameters of a mix file (all but ``prompt`` and ``output`` optional)::

    {"arrival": "poisson" | "closed", "rate": requests/s, "clients": n,
     "prompt": {"dist": "lognormal", "median": 64, "sigma": 0.7,
                "min": 16, "max": 256}  |  {"dist": "uniform", ...},
     "output": {"dist": "uniform", "min": 128, "max": 512},
     "zipf_s": 1.1, "pool": 64,
     "prefix": {"count": 4, "len": 512, "zipf_s": 1.3},
     "diurnal": {"period_s": 16.0, "amplitude": 0.8}}
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()
ORDER_SEED = 20261018           # orders the pooled sizes and gaps


def sample_expert_probs(E: int, rng: np.random.Generator,
                        zipf_s: float = 1.1) -> np.ndarray:
    """Zipf-ranked probabilities with a random rank permutation (the
    port's ``sim.workload.sample_expert_probs``)."""
    ranks = np.arange(1, E + 1, dtype=np.float64)
    p = ranks ** (-zipf_s)
    p /= p.sum()
    return p[rng.permutation(E)]


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def length_pool(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles of ``dist``, clipped to its range."""
    u = _quantiles(n)
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
        vals = np.rint(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    elif dist["dist"] == "uniform":
        vals = lo + np.floor(u * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(vals, lo, hi).astype(np.int64)


def _seed(seed: int, *tags: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_new: int


class Traffic:
    """The request stream of one (traffic block, seed, vocabulary).

    ``request(i)`` is the i-th request, drawn on demand and the same for
    the same seed; ``arrivals(n)`` the first ``n`` due times in seconds
    after the stream's origin (open loop)."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.p = params
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.pool = int(params.get("pool", 64))
        self._prompt_pool = length_pool(params["prompt"], self.pool)
        self._output_pool = length_pool(params["output"], self.pool)
        self._perm_cache = {}
        self._made: dict = {}
        self.prefixes: List[List[int]] = []
        self._prefix_probs: Optional[np.ndarray] = None
        pre = params.get("prefix")
        if pre:
            rng = np.random.default_rng(_seed(seed, 3))
            for _ in range(int(pre["count"])):
                probs = sample_expert_probs(self.vocab, rng,
                                            float(params.get("zipf_s", 1.1)))
                self.prefixes.append(rng.choice(self.vocab, size=int(pre["len"]),
                                                p=probs).tolist())
            self._prefix_probs = sample_expert_probs(
                len(self.prefixes), rng, float(pre.get("zipf_s", 1.3)))

    def _perm(self, kind: int, block: int) -> np.ndarray:
        key = (kind, block)
        perm = self._perm_cache.get(key)
        if perm is None:
            perm = self._perm_cache[key] = np.random.default_rng(
                _seed(ORDER_SEED, 1, kind, block)).permutation(self.pool)
        return perm

    def _pooled(self, pool: np.ndarray, kind: int, i: int):
        block, j = divmod(i, self.pool)
        return pool[self._perm(kind, block)[j]]

    def request(self, i: int) -> Request:
        """The i-th request (drawn once, then kept)."""
        got = self._made.get(i)
        if got is None:
            got = self._made[i] = self._draw(i)
        return got

    def prefetch(self, n: int) -> None:
        """Draw the first ``n`` requests now (in set-up, not in the
        window: a draw over a 100k vocabulary takes milliseconds)."""
        for i in range(n):
            self.request(i)

    def _draw(self, i: int) -> Request:
        plen = int(self._pooled(self._prompt_pool, 0, i))
        max_new = int(self._pooled(self._output_pool, 1, i))
        rng = np.random.default_rng(_seed(self.seed, 2, i))
        probs = sample_expert_probs(self.vocab, rng,
                                    float(self.p.get("zipf_s", 1.1)))
        prompt = rng.choice(self.vocab, size=plen, p=probs).tolist()
        if self.prefixes:
            k = int(rng.choice(len(self.prefixes), p=self._prefix_probs))
            prompt = self.prefixes[k] + prompt
        return Request(i, [int(t) for t in prompt], max_new)

    def arrivals(self, n: int) -> np.ndarray:
        """Due times of the first ``n`` requests: a Poisson process at
        ``rate`` whose gaps are the pooled quantiles of the exponential,
        time-warped through the integrated rate when ``diurnal``."""
        rate = float(self.p["rate"])
        gaps_unit = -np.log1p(-_quantiles(self.pool))      # Exp(1) quantiles
        gaps = np.array([gaps_unit[self._perm(4, b)[j]]
                         for b, j in (divmod(i, self.pool) for i in range(n))])
        s = np.cumsum(gaps) / rate                          # operational time
        cyc = self.p.get("diurnal")
        if not cyc:
            return s
        # rate(t) = rate * (1 + A sin(2 pi t / P)); its integral over [0, t]
        # divided by rate is monotone for A < 1, so invert it on a grid
        A, P = float(cyc["amplitude"]), float(cyc["period_s"])
        t = np.linspace(0.0, float(s[-1]) * 2.0 + P, 200_001)
        lam = t + A * P / (2 * np.pi) * (1.0 - np.cos(2 * np.pi * t / P))
        return np.interp(s, lam, t)

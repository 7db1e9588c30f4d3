"""Poisson traffic for closed-loop serving (port of
``repro.serving.traffic``).

Arrivals are a Poisson process (exponential gaps at ``rate`` requests per
clock unit); prompt sizes come from the chiplet simulator's request
splitter (``sim.workload.make_requests``, Poisson-sized around
``avg_prompt``), and each request draws its prompt from a private Zipf
affinity over the vocabulary (``sim.workload.sample_expert_probs``
seeded by the request), which gives the long-tail expert activation the
dynamic trajectory feeds on.  ``TrafficConfig.mix`` adds "+"-separated
modifiers: ``zipf_prefix`` (Zipf-shared system prompts, the shape prefix
caching feeds on) and ``diurnal`` (a sinusoidal arrival-rate cycle).
The streams are the reference's, byte for byte.  The simulator replay
view (``to_sim_requests``) waits with the simulator.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.sim import workload as sim_workload


@dataclass
class TrafficConfig:
    num_requests: int = 32
    rate: float = 0.5                # Poisson arrivals per time unit
    avg_prompt: int = 12             # mean prompt length (Poisson-sized)
    min_prompt: int = 1
    max_prompt: int = 64
    min_new: int = 2
    max_new: int = 8                 # output lengths uniform in [min,max]
    zipf_s: float = 1.1              # per-request token-affinity skew
    vocab: int = 256
    num_chiplets: int = 4            # home-chiplet striping for the sim
    seed: int = 0
    # traffic mix: "poisson" plus "+"-separated modifiers —
    # "zipf_prefix" (Zipf-shared system prompts) and/or "diurnal"
    # (sinusoidal arrival-rate bursts), e.g. "poisson+zipf_prefix"
    mix: str = "poisson"
    num_prefixes: int = 4            # distinct shared system prompts
    prefix_len: int = 12             # tokens per shared prompt
    prefix_zipf_s: float = 1.3       # skew of prefix popularity
    burst_period: float = 16.0       # diurnal cycle (clock units)
    burst_amplitude: float = 0.8     # rate modulation depth in [0, 1)

    def __post_init__(self):
        unknown = set(self.mix.split("+")) - {"poisson", "zipf_prefix",
                                              "diurnal"}
        if unknown:
            raise ValueError(f"unknown traffic mix component(s) "
                             f"{sorted(unknown)} — want 'poisson', "
                             f"'zipf_prefix', 'diurnal' joined by '+'")


@dataclass
class TrafficRequest:
    rid: str
    arrival: float
    prompt: List[int] = field(default_factory=list)
    max_new: int = 1
    affinity_seed: int = 0
    home_chiplet: int = 0


def make_traffic(cfg: TrafficConfig) -> List[TrafficRequest]:
    """Deterministic request stream for one (config, seed)."""
    rng = np.random.default_rng(cfg.seed)
    # request-size / affinity structure from the simulator's splitter:
    # ask for enough token budget that >= num_requests fall out, then
    # keep exactly num_requests
    sized: List[sim_workload.Request] = []
    budget = cfg.num_requests * max(1, cfg.avg_prompt)
    attempt = 0
    # growing the budget only *extends* the splitter's request list (the
    # rng sequence is a pure function of the seed), so the stream is
    # stable under retries and distinct across seeds
    while len(sized) < cfg.num_requests:
        sized = sim_workload.make_requests(
            budget, cfg.num_chiplets, cfg.seed,
            avg_request_tokens=cfg.avg_prompt)
        budget *= 2
        attempt += 1
        if attempt > 16:
            raise RuntimeError("traffic splitter failed to produce "
                               f"{cfg.num_requests} requests")
    sized = sized[:cfg.num_requests]

    parts = set(cfg.mix.split("+"))
    prefixes: List[List[int]] = []
    prefix_probs = None
    if "zipf_prefix" in parts:
        # shared system prompts, deterministic per seed; popularity is
        # Zipf-skewed via the simulator's sampler (a hot head of reused
        # prefixes is the workload prefix caching feeds on).  At least
        # one private token must follow, so cap at max_prompt - 1.
        prng = np.random.default_rng(cfg.seed + 10_007)
        plen_shared = min(cfg.prefix_len, max(1, cfg.max_prompt - 1))
        for _ in range(cfg.num_prefixes):
            pprobs = sim_workload.sample_expert_probs(cfg.vocab, prng,
                                                      zipf_s=cfg.zipf_s)
            prefixes.append(prng.choice(cfg.vocab, size=plen_shared,
                                        p=pprobs).tolist())
        prefix_probs = sim_workload.sample_expert_probs(
            cfg.num_prefixes, prng, zipf_s=cfg.prefix_zipf_s)

    out: List[TrafficRequest] = []
    now = 0.0
    for i, req in enumerate(sized):
        rate = max(cfg.rate, 1e-9)
        if "diurnal" in parts:
            # sinusoidal rate modulation: bursts above the mean rate
            # alternate with troughs (queue pressure)
            phase = np.sin(2.0 * np.pi * now / max(cfg.burst_period, 1e-9))
            rate = max(rate * (1.0 + cfg.burst_amplitude * phase), 1e-9)
        now += float(rng.exponential(1.0 / rate))
        plen = int(np.clip(req.num_tokens, cfg.min_prompt, cfg.max_prompt))
        # per-request Zipf affinity over the vocab: a private permutation
        # of Zipf-ranked probabilities, seeded by the request's affinity
        # seed (the simulator uses the identical construction over experts)
        arng = np.random.default_rng(req.affinity_seed)
        probs = sim_workload.sample_expert_probs(cfg.vocab, arng,
                                                 zipf_s=cfg.zipf_s)
        prompt = arng.choice(cfg.vocab, size=plen, p=probs).tolist()
        if prefixes:
            shared = prefixes[int(rng.choice(len(prefixes),
                                             p=prefix_probs))]
            keep = max(1, cfg.max_prompt - len(shared))
            prompt = shared + prompt[:keep]
        max_new = int(rng.integers(cfg.min_new, cfg.max_new + 1))
        out.append(TrafficRequest(rid=f"traffic{i}", arrival=now,
                                  prompt=[int(t) for t in prompt],
                                  max_new=max_new,
                                  affinity_seed=req.affinity_seed,
                                  home_chiplet=req.home_chiplet))
    return out


def run_closed_loop(scheduler, traffic: List[TrafficRequest], *,
                    dt: float = 1.0, max_iterations: int = 100_000) -> dict:
    """Feed a traffic stream through a Scheduler until it drains.

    Arrival times are interpreted on the scheduler's clock (iteration
    counts advancing by ``dt`` per step unless the scheduler was built
    with a wall clock or ``clock="modeled"``): every request whose
    arrival time has passed is offered before the next step.  Returns ``{"metrics": ServingMetrics,
    "outputs": {rid: tokens}, "dropped": [rid, ...]}`` — dropped
    requests hit the bounded queue.
    """
    todo = sorted(traffic, key=lambda t: (t.arrival, t.rid))
    i = 0
    dropped: List[str] = []
    offered: dict = {}
    iters = 0
    while True:
        while i < len(todo) and todo[i].arrival <= scheduler.now:
            rid = scheduler.offer(todo[i].prompt, todo[i].max_new,
                                  arrival=todo[i].arrival)
            if rid is None:
                dropped.append(todo[i].rid)
            else:
                offered[rid] = todo[i].rid
            i += 1
        if i >= len(todo) and not scheduler.pending():
            break
        if not scheduler.pending() and callable(scheduler.clock):
            # wall-clocked and idle before the next arrival: sleep the
            # gap out (bounded slices so the loop stays responsive)
            # instead of burning engine iterations — idle waits do not
            # count against the drain budget
            time.sleep(min(0.05, max(1e-4,
                                     todo[i].arrival - scheduler.now)))
            scheduler.now = scheduler.clock() - scheduler._t0
            continue
        if not scheduler.pending() and scheduler.clock == "modeled":
            # modeled-clocked and idle: the modeled clock only advances
            # with engine compute, so event-skip straight to the next
            # arrival instead of spinning empty iterations
            scheduler.now = max(scheduler.now, todo[i].arrival)
            continue
        scheduler.step(dt=dt)
        iters += 1
        if iters >= max_iterations:
            raise RuntimeError("closed loop did not drain")
    outputs = {offered[rid]: toks
               for rid, toks in scheduler.outputs().items()
               if rid in offered}
    return {"metrics": scheduler.metrics(), "outputs": outputs,
            "dropped": dropped}

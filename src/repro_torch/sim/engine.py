"""Discrete-event chiplet simulator for MoE layer execution (port of
``repro.sim.engine``).

Implements the paper's virtualization rules at micro-slice granularity:

  Rule 1 — a micro-slice received in the previous step is computed
           immediately while simultaneously being forwarded along the
           trajectory (compute queue is LIFO on arrival time);
  Rule 2 — if nothing was just received, any resident micro-slice is
           computed/forwarded (the LIFO stack degenerates to this);
  Rule 3 — storage is released after the last station's compute;
  Rule 4 — DDR loads proceed whenever a channel and destination buffer
           space are available;
  Rule 5 — (optional) DDR steers each load to the trajectory chiplet
           with the most free buffer.

The same event engine also runs the EP / Hydra baselines (experts
pinned to an owner chiplet, tokens travel, whole-expert residency with
double-buffered prefetch) so all strategies share the identical
hardware model.  Expert admission follows Algorithm 1 (spatiotemporal
trajectory scheduling) driven by the idle-chiplet vector.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policies import paired_load_order
from .hardware import HardwareConfig, ModelSpec
from .workload import LayerWorkload


@dataclass
class LayerResult:
    latency: float
    utilization: float                  # mean compute-busy fraction
    peak_buffer_bytes: int              # package-wide peak
    peak_buffer_per_chip: np.ndarray
    ddr_bytes: float
    d2d_bytes: float
    busy_time: np.ndarray               # per-chiplet compute busy seconds
    timeline: List[tuple] = field(default_factory=list)  # (t, chip, kind, dur)
    dropped_experts: List[int] = field(default_factory=list)

    @property
    def util_curve(self):
        return self.timeline

    def util_series(self, bins: int = 32) -> np.ndarray:
        """Binned compute-utilization curve in [0, 1].

        Splits the makespan into ``bins`` equal windows and returns the
        fraction of (chiplet x window) capacity spent in ``compute:*``
        timeline events (needs ``record_timeline=True``).
        """
        P = len(self.peak_buffer_per_chip)
        span = max(self.latency, 1e-12)
        width = span / bins
        busy = np.zeros(bins, np.float64)
        for t, _chip, kind, dur in self.timeline:
            if not str(kind).startswith("compute"):
                continue
            t0, t1 = t, min(t + dur, span)
            b0 = min(bins - 1, int(t0 / width))
            b1 = min(bins - 1, int(max(t1 - 1e-18, t0) / width))
            for b in range(b0, b1 + 1):
                lo, hi = b * width, (b + 1) * width
                busy[b] += max(0.0, min(t1, hi) - max(t0, lo))
        return busy / (P * width)


class _MicroSlice:
    __slots__ = ("uid", "expert", "idx", "bytes", "route", "pos",
                 "computed_here", "xfer_done_here", "arrival")

    def __init__(self, uid, expert, idx, nbytes, route):
        self.uid = uid
        self.expert = expert
        self.idx = idx
        self.bytes = nbytes
        self.route = route            # list of chiplet ids to visit, in order
        self.pos = 0                  # index into route (current station)
        self.computed_here = False
        self.xfer_done_here = True    # no inbound transfer initially
        self.arrival = 0.0

    @property
    def station(self):
        return self.route[self.pos]

    @property
    def last(self):
        return self.pos == len(self.route) - 1


class ChipletSim:
    """One MoE layer on the chiplet array under a given strategy."""

    def __init__(self, hw: HardwareConfig, spec: ModelSpec, wl: LayerWorkload,
                 *, strategy: str = "fse_dp", micro_slices: int = 8,
                 order: str = "paired", rule5: bool = False,
                 max_inflight_experts: Optional[int] = None,
                 record_timeline: bool = False):
        assert strategy in ("fse_dp", "fse_dp_naive", "ep", "hydra")
        self.hw, self.spec, self.wl = hw, spec, wl
        self.P = hw.num_chiplets
        self.strategy = strategy
        self.micro = max(1, micro_slices)
        self.order = order
        self.rule5 = rule5
        self.record_timeline = record_timeline
        self.max_inflight = max_inflight_experts or max(2, self.P)
        self._uid = itertools.count()
        self._seq = itertools.count()

    # ---------------- shared machinery ----------------

    def _expert_order(self) -> List[int]:
        totals = self.wl.expert_totals
        active = [e for e in range(self.spec.num_experts) if totals[e] > 0]
        if self.order == "paired":
            return [e for e in paired_load_order(totals) if totals[e] > 0]
        if self.order == "sorted":
            return sorted(active, key=lambda e: -totals[e])
        return active

    def _trajectory(self, e: int) -> List[int]:
        """Chiplets holding tokens for e, ring order (logical ring, §VI-A)."""
        chips = [c for c in range(self.P) if self.wl.counts[c, e] > 0]
        return chips

    def _compute_time(self, chip: int, e: int, frac: float) -> float:
        n_tok = int(self.wl.counts[chip, e])
        return n_tok * self.spec.expert_flops_per_token() * frac / self.hw.tops

    # ---------------- event-driven run ----------------

    def run(self) -> LayerResult:
        hw, spec = self.hw, self.spec
        P = self.P
        now = 0.0
        events: List[tuple] = []

        order = self._expert_order()
        # pending expert queue (Algorithm 1's E_sorted)
        queue: List[int] = list(order)
        inflight: Dict[int, int] = {}          # expert -> outstanding micro-slices
        idle = np.ones(P, bool)                # ICV — idle-chiplet vector

        # resources
        compute_free = np.zeros(P)             # next free time per chip engine
        compute_stack: List[List[_MicroSlice]] = [[] for _ in range(P)]
        computing: List[Optional[_MicroSlice]] = [None] * P
        port_free = np.zeros(P)                # out-port next free time
        xfer_queue: List[List[_MicroSlice]] = [[] for _ in range(P)]
        buf_used = np.zeros(P)
        buf_peak = np.zeros(P)
        ddr_free = np.zeros(hw.ddr_channels)
        pending_loads: List[Tuple[int, _MicroSlice]] = []   # (entry_chip, ms)
        busy = np.zeros(P)
        ddr_bytes = 0.0
        d2d_bytes = 0.0
        timeline: List[tuple] = []
        dropped: List[int] = []

        whole_expert = self.strategy in ("ep", "hydra")
        if whole_expert:
            self.max_inflight = spec.num_experts + 1

        # --- placement for EP / Hydra ---
        owner = {}
        if whole_expert:
            totals = self.wl.expert_totals
            if self.strategy == "ep":
                for e in range(spec.num_experts):
                    owner[e] = e % P
            else:  # hydra: greedy least-loaded by token count (popularity-aware)
                load = np.zeros(P)
                for e in sorted(range(spec.num_experts), key=lambda e: -totals[e]):
                    c = int(np.argmin(load))
                    owner[e] = c
                    load[c] += totals[e] * spec.expert_flops_per_token() / hw.tops \
                        + spec.expert_bytes / hw.ddr_total

        def unit_count(traj_len: int) -> int:
            # two-level split (paper Fig. 4): expert -> per-chiplet slice ->
            # micro-slices; auto-refine so one unit fits half a buffer
            n = traj_len * self.micro
            while spec.expert_bytes / n > hw.buffer_bytes / 2 and n < 4096:
                n += traj_len
            return n

        def make_slices(e: int) -> List[_MicroSlice]:
            traj = self._trajectory(e)
            if not traj:
                return []
            if whole_expert:
                # whole expert resident at owner; tokens travel (handled as
                # extra pre/post token-transfer time charged to compute chain)
                route = [owner[e]]
                n = 1
                nbytes = spec.expert_bytes
            else:
                route = traj
                n = unit_count(len(traj))
                nbytes = spec.expert_bytes / n
            out = []
            for i in range(n):
                # entry chiplet: slices round-robin over the trajectory
                entry = route[i % len(route)]
                start = route.index(entry)
                ring = route[start:] + route[:start]
                ms = _MicroSlice(next(self._uid), e, i, nbytes, ring)
                out.append(ms)
            return out

        def token_io_time(e: int) -> float:
            """EP/Hydra: gather tokens to the owner + scatter results back."""
            n_remote = int(self.wl.expert_totals[e] - self.wl.counts[owner[e], e])
            vol = 2.0 * n_remote * spec.d_model * hw.bytes_per_act  # in + out
            return vol / hw.d2d_gbps + hw.d2d_hop_latency

        def try_admit():
            """Algorithm 1 main loop body."""
            admitted = True
            while admitted and queue and len(inflight) < self.max_inflight:
                admitted = False
                # pass 1: expert whose trajectory covers an idle chiplet
                for qi, e in enumerate(queue):
                    traj = self._trajectory(e)
                    if not traj:
                        queue.pop(qi)
                        dropped.append(e)
                        admitted = True
                        break
                    if any(idle[c] for c in traj):
                        queue.pop(qi)
                        admit(e, traj)
                        admitted = True
                        break
                if admitted:
                    continue
                # pass 2 (Rule 4 / Alg.1 line 12): preload next expert if any
                # buffer anywhere on its trajectory has room for one slice
                e = queue[0]
                traj = self._trajectory(e)
                need = spec.expert_bytes if whole_expert \
                    else spec.expert_bytes / unit_count(len(traj))
                if any(buf_used[c] + need <= hw.buffer_bytes for c in traj):
                    queue.pop(0)
                    admit(e, traj)
                    admitted = True

        def admit(e: int, traj: List[int]):
            slices = make_slices(e)
            inflight[e] = len(slices)
            for c in traj:
                idle[c] = False
            for ms in slices:
                pending_loads.append((ms.route[0], ms))

        def try_start_loads():
            nonlocal ddr_bytes
            i = 0
            while i < len(pending_loads):
                entry, ms = pending_loads[i]
                if self.rule5 and not whole_expert:
                    # Rule 5: steer to trajectory chiplet with most free buffer
                    entry = min(ms.route, key=lambda c: buf_used[c])
                    start = ms.route.index(entry)
                    ms.route = ms.route[start:] + ms.route[:start]
                    ms.pos = 0
                if whole_expert:
                    # double-buffered prefetch: at most 2 experts resident
                    if buf_used[entry] >= 2 * spec.expert_bytes:
                        i += 1
                        continue
                elif buf_used[entry] + 2 * ms.bytes > hw.buffer_bytes:
                    # Rule 4 + one receive slot of headroom (ring deadlock
                    # avoidance: transfers must always be able to land)
                    i += 1
                    continue
                pending_loads.pop(i)
                buf_used[entry] += ms.bytes
                buf_peak[entry] = max(buf_peak[entry], buf_used[entry])
                ch = int(np.argmin(ddr_free))
                dur = ms.bytes / hw.ddr_gbps_per_channel
                t0 = max(now, ddr_free[ch])
                ddr_free[ch] = t0 + dur
                ddr_bytes += ms.bytes
                if self.record_timeline:
                    timeline.append((t0, entry, f"load:e{ms.expert}:u{ms.uid}",
                                     dur))
                heapq.heappush(events, (t0 + dur, next(self._seq), "load_done", ms))

        def try_start_compute():
            for c in range(P):
                if computing[c] is not None or compute_free[c] > now:
                    continue
                if not compute_stack[c]:
                    continue
                ms = compute_stack[c].pop()      # LIFO — Rule 1 (eager)
                computing[c] = ms
                frac = ms.bytes / spec.expert_bytes   # unit's share of the expert
                dur = self._compute_time(c, ms.expert, frac)
                if whole_expert:
                    dur += token_io_time(ms.expert)
                busy[c] += dur
                compute_free[c] = now + dur
                if self.record_timeline:
                    timeline.append((now, c, f"compute:e{ms.expert}:u{ms.uid}",
                                     dur))
                heapq.heappush(events, (now + dur, next(self._seq), "compute_done", ms))
                # Rule 1: forward simultaneously with compute
                if not ms.last:
                    ms.xfer_done_here = False
                    xfer_queue[c].append(ms)

        def try_start_xfers():
            nonlocal d2d_bytes
            for c in range(P):
                if port_free[c] > now or not xfer_queue[c]:
                    continue
                ms = xfer_queue[c][0]
                dst = ms.route[ms.pos + 1]
                # Transfers always land (elastic micro-slice buffer, §VI-B):
                # gating only DDR injection keeps the ring deadlock-free while
                # the reported peak shows any capacity exceedance.
                xfer_queue[c].pop(0)
                buf_used[dst] += ms.bytes        # reserve at receiver
                buf_peak[dst] = max(buf_peak[dst], buf_used[dst])
                hops = max(1, self.hw.hops(c, dst))
                dur = ms.bytes / hw.d2d_gbps + hops * hw.d2d_hop_latency
                port_free[c] = now + dur
                d2d_bytes += ms.bytes
                if self.record_timeline:
                    timeline.append((now, c, f"xfer:e{ms.expert}:u{ms.uid}",
                                     dur))
                heapq.heappush(events, (now + dur, next(self._seq), "xfer_done", (ms, c, dst)))

        def maybe_release(ms: _MicroSlice, chip: int):
            """Rule 3 + post-forward release at intermediate stations."""
            if ms.computed_here and ms.xfer_done_here:
                buf_used[chip] -= ms.bytes
                if ms.last:
                    finish_slice(ms)
                else:
                    ms.pos += 1
                    ms.computed_here = False
                    ms.xfer_done_here = True
                    ms.arrival = now
                    compute_stack[ms.station].append(ms)

        def finish_slice(ms: _MicroSlice):
            inflight[ms.expert] -= 1
            if inflight[ms.expert] == 0:
                del inflight[ms.expert]
                # Alg.1 line 15: release chiplets not engaged elsewhere
                engaged = set()
                for st in compute_stack:
                    engaged.update(m.station for m in st)
                for e2 in inflight:
                    engaged.update(self._trajectory(e2))
                for c in range(P):
                    if c not in engaged and computing[c] is None:
                        idle[c] = True

        try_admit()
        try_start_loads()
        guard = 0
        while events or pending_loads or any(compute_stack) or any(xfer_queue) \
                or queue or inflight:
            guard += 1
            if guard > 2_000_000:
                raise RuntimeError("simulator livelock")
            if not events:
                raise RuntimeError(
                    f"sim deadlock at t={now:.3e}: loads={len(pending_loads)} "
                    f"queue={len(queue)} inflight={dict(inflight)}")
            else:
                t, _, kind, payload = heapq.heappop(events)
                now = max(now, t)
                if kind == "load_done":
                    ms = payload
                    ms.computed_here = False
                    ms.xfer_done_here = True
                    ms.arrival = now
                    compute_stack[ms.station].append(ms)
                elif kind == "compute_done":
                    ms = payload
                    chip = ms.station
                    computing[chip] = None
                    ms.computed_here = True
                    if ms.last:
                        ms.xfer_done_here = True
                    maybe_release(ms, chip)
                elif kind == "xfer_done":
                    ms, src, dst = payload
                    ms.xfer_done_here = True
                    maybe_release(ms, src)
            try_admit()
            try_start_loads()
            try_start_xfers()
            try_start_compute()

        makespan = max(now, 1e-12)
        util = float(busy.sum() / (P * makespan))
        return LayerResult(
            latency=makespan, utilization=util,
            peak_buffer_bytes=int(buf_peak.sum()),
            peak_buffer_per_chip=buf_peak.copy(),
            ddr_bytes=ddr_bytes, d2d_bytes=d2d_bytes, busy_time=busy.copy(),
            timeline=timeline, dropped_experts=dropped)


# ---------------------------------------------------------------------------
# A1: naive FSE-DP (phase-synchronized, no fine-grained flow) — §III
# ---------------------------------------------------------------------------

def simulate_naive_fsedp(hw: HardwareConfig, spec: ModelSpec,
                         wl: LayerWorkload) -> LayerResult:
    P = hw.num_chiplets
    totals = wl.expert_totals
    t = 0.0
    busy = np.zeros(P)
    ddr_bytes = 0.0
    d2d_bytes = 0.0
    peak = np.zeros(P)
    for e in range(spec.num_experts):
        if totals[e] == 0:
            continue
        traj = [c for c in range(P) if wl.counts[c, e] > 0]
        S = len(traj)
        slice_bytes = spec.expert_bytes / S
        # load S slices in parallel over DDR channels (no overlap w/ compute)
        t_load = slice_bytes / hw.ddr_gbps_per_channel * np.ceil(S / hw.ddr_channels)
        ddr_bytes += spec.expert_bytes
        # S synchronized phases: each phase max(compute, transfer)
        t_phases = 0.0
        for ph in range(S):
            comp = max(wl.counts[c, e] * spec.expert_flops_per_token() / S / hw.tops
                       for c in traj)
            xfer = slice_bytes / hw.d2d_gbps + hw.d2d_hop_latency if S > 1 else 0.0
            t_phases += comp + (xfer if ph < S - 1 else 0.0)
            d2d_bytes += slice_bytes * (S if ph < S - 1 else 0)
        for c in traj:
            busy[c] += wl.counts[c, e] * spec.expert_flops_per_token() / hw.tops
        # double residency: current slice + incoming slice (paper §IV point 1)
        for c in traj:
            peak[c] = max(peak[c], 2 * slice_bytes)
        t += t_load + t_phases
    makespan = max(t, 1e-12)
    return LayerResult(latency=makespan, utilization=float(busy.sum() / (P * makespan)),
                       peak_buffer_bytes=int(peak.sum()), peak_buffer_per_chip=peak,
                       ddr_bytes=ddr_bytes, d2d_bytes=d2d_bytes, busy_time=busy)


# ---------------------------------------------------------------------------
# strategy front-door
# ---------------------------------------------------------------------------

def simulate_layer(hw: HardwareConfig, spec: ModelSpec, wl: LayerWorkload,
                   strategy: str, **kw) -> LayerResult:
    """strategy: ep | hydra | fse_dp_naive (A1) | fse_dp (A2) |
    fse_dp_paired (A3) | fse_dp_rule5 (A4)."""
    if strategy == "fse_dp_naive":
        return simulate_naive_fsedp(hw, spec, wl)
    if strategy == "fse_dp":
        return ChipletSim(hw, spec, wl, strategy="fse_dp", order="natural", **kw).run()
    if strategy == "fse_dp_paired":
        return ChipletSim(hw, spec, wl, strategy="fse_dp", order="paired", **kw).run()
    if strategy == "fse_dp_rule5":
        return ChipletSim(hw, spec, wl, strategy="fse_dp", order="paired",
                          rule5=True, **kw).run()
    if strategy in ("ep", "hydra"):
        return ChipletSim(hw, spec, wl, strategy=strategy, **kw).run()
    raise ValueError(strategy)

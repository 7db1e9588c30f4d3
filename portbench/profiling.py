"""The traced segment: ``torch.profiler`` over a few steady steps, reduced
to what the readers need (device busy time, kernel time by name and by
source file, the longest idle gaps by what the host was doing).

The window is a span the benchmark opens around the steps, on the
profiler's own clock, and it closes as soon as the device is idle (a
synchronize).  Device records are clipped to it: kineto's stamps on the
card can stray past the host's view of the work (a few ms at the end,
and the first records of a profile), so two warm-up steps run inside
the profile before the span opens.  The kernel-time arithmetic and the
busy share are the repository's own (``tools/profiler_window.py``,
``chip_smoke.py`` phase 11), copied here.
"""
from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Tuple

SPAN = "portbench.window"
GAP_MIN_NS = 5_000              # idle gaps shorter than this are not named


def port_kernels(root: Path) -> Dict[str, str]:
    """Every ``__global__`` function of the port's CUDA sources -> the
    source's stem (``streamed_moe``, ``flash_attention``, ``ssd``): the
    program's kernel names, read from its sources at run time."""
    out = {}
    for src in sorted((root / "src" / "repro_torch" / "kernels" / "csrc")
                      .glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                             r"\([^)]*\)\s*)?([A-Za-z_]\w*)", text):
            out[m.group(1)] = src.stem
    return out


def kernel_ident(name: str) -> str:
    """``void (anonymous namespace)::up_kernel_wg<Cfg<...>>(CUtensorMap,
    ...)`` -> ``up_kernel_wg``."""
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def _gap_name(active) -> str:
    """What the host was doing across an idle gap: the innermost host
    event, inside the innermost of the benchmark's own spans."""
    if not active:
        return "host idle"
    inner = min(active, key=lambda e: e[0] - e[1])[2]
    ours = [e for e in active if e[2].startswith("portbench.")]
    if ours and not inner.startswith("portbench."):
        return f"{inner} in {min(ours, key=lambda e: e[0] - e[1])[2]}"
    return inner


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]     # name -> (seconds, count)
    by_source: Dict[str, Tuple[float, int]]   # port source or "library"
    idle_gaps: List[Tuple[str, float]]
    steps: list = field(default_factory=list)  # the driver's records

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        rows = sorted(((s, k) for k, (s, _) in self.kernels.items()),
                      reverse=True)[:n]
        return [[k, s] for s, k in rows]


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    merged = []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
        total += cur_e - cur_s
    return total, merged


def profile(step: Callable[[], None], n: int, sources: Dict[str, str],
            sync: Callable[[], None]) -> Summary:
    """Run ``step`` 2 + ``n`` times under the profiler; summarise the last
    ``n``, from the span's open to the device's idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        sync()
        with record_function(SPAN):
            for _ in range(n):
                step()
            sync()
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == SPAN
             and e.device_type() == DeviceType.CPU]
    if not spans:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = spans[0].start_ns(), spans[0].end_ns()
    dev, cpu = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name().startswith("portbench."):
                continue            # the spans' device-side annotations
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t, e.name()))
        elif e.name() != SPAN and t > w0 and s < w1:
            cpu.append((s, t, e.name()))
    busy_ns, merged = _union([(s, t) for s, t, _ in dev])
    kernels: Dict[str, list] = {}
    by_source: Dict[str, list] = {}
    for s, t, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e9
        k[1] += 1
        src = sources.get(kernel_ident(name), "library")
        b = by_source.setdefault(src, [0.0, 0])
        b[0] += (t - s) / 1e9
        b[1] += 1
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    cpu.sort()
    active: list = []                       # heap of (end, start, name)
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < GAP_MIN_NS:
            continue
        mid = (a + b) // 2
        while nxt < len(cpu) and cpu[nxt][0] <= mid:
            s, t, name = cpu[nxt]
            heapq.heappush(active, (t, s, name))
            nxt += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        gaps_key = _gap_name(active)
        gaps[gaps_key] = gaps.get(gaps_key, 0.0) + (b - a) / 1e9
    idle = sorted(((v, k) for k, v in gaps.items()), reverse=True)[:10]
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                   kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                   by_source={k: (v[0], v[1]) for k, v in by_source.items()},
                   idle_gaps=[[k, v] for v, k in idle])

#!/usr/bin/env python3
"""Show how the profiler's capture window decides which device records of
a warm traffic run it keeps, on one GPU.

    python3 tools/profiler_window.py [RUNS]

It builds the kernels, serves ``chip_smoke.py``'s traffic stream once on
the fused engine (capturing its graphs), then profiles the same stream
on that engine RUNS times (default 8) with the capture window opened
just before the run and closed as soon as the device is idle, and RUNS
times as ``chip_smoke.py`` profiles (``PROFILE_PAD_S`` on each side,
``PROFILE_WARMUP`` spin kernels first), in turn.  Each run prints its
setting, the process's age, the device records kept (the run's, and the
spin kernels'), the ``up_kernel`` records against the launches the
engine counted, and how far past the host's idle time the last device
record ends.  Kineto drops every device record stamped outside its
window.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

T_START = time.perf_counter()


def profile_once(eng, pad, warmup):
    from torch.autograd import DeviceType
    cs._zero_counts(eng)
    saved = cs.PROFILE_PAD_S, cs.PROFILE_WARMUP
    cs.PROFILE_PAD_S, cs.PROFILE_WARMUP = pad, warmup
    try:
        _, rows, events, late, spins = cs._profiled(lambda: cs._traffic(eng))
    finally:
        cs.PROFILE_PAD_S, cs.PROFILE_WARMUP = saved
    records = sum(1 for e in events if e.device_type() == DeviceType.CUDA)
    up = sum(n for _, n, name in rows if "up_kernel" in name)
    counted = cs._launches(eng)
    print(f"[window] pad {pad}s, {warmup} spin kernels first, process age "
          f"{time.perf_counter() - T_START:.0f}s: {records - spins} device "
          f"records of the run, {spins} of the spin kernels', up_kernel "
          f"{up} of {counted} counted"
          f"{'' if up == counted else ' (MISSING ' + str(counted - up) + ')'}, "
          f"last record ends {late:.3f} ms after the host saw the device "
          f"idle", flush=True)
    return up == counted


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cs.phase_env()
    cs.phase_build()
    eng = cs._traffic()["engine"]
    settings = ((0.0, 0), (cs.PROFILE_PAD_S, cs.PROFILE_WARMUP))
    ok = dict.fromkeys(settings, 0)
    for _ in range(runs):
        for pad, warmup in settings:
            ok[pad, warmup] += profile_once(eng, pad, warmup)
    for (pad, warmup), n in ok.items():
        print(f"[window] pad {pad}s, {warmup} spin kernels first: up_kernel "
              f"records complete in {n} of {runs} runs", flush=True)


if __name__ == "__main__":
    main()

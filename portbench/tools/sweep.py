#!/usr/bin/env python3
"""Find an open-loop cell's knee: serve its traffic at each of a few
fixed rates and report, per rate, the latency tails and whether the
queue grew through the window.

    python3 portbench/tools/sweep.py --workload <cell> --rates 2,3,4 \
        --seconds 30 --seed 5

The knee is the highest rate whose queue does not grow through the
window; the cell's rate is then fixed, as a number in its traffic mix,
at about 4/5 of it.  Prints one JSON line a rate.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import harness, stats  # noqa: E402
from portbench.readers import due_in_window  # noqa: E402


def at_rate(cell_name: str, rate: float, seconds: float, seed: int) -> dict:
    import torch
    cell, conf, mix = harness.load(cell_name, harness.benchmark())
    mix = dict(mix, rate=rate)
    ctx = harness.Context(cell_name, cell, conf, mix, seed, seconds, False,
                          device=torch.device("cuda", 0),
                          model_cfg=harness.model_config(conf),
                          t_start=harness.now())
    correct = harness.driver(cell["driver"]).run(ctx)
    reqs = sorted(due_in_window(ctx), key=lambda r: r.due)
    third = max(1, len(reqs) // 3)

    def ttft(rs, q):
        return 1e3 * stats.percentile([r.token_t[0] - r.due for r in rs
                                       if r.token_t], q)
    a, b = ctx.window
    done = [r for r in ctx.requests.values()
            if r.done_t is not None and a <= r.done_t < b]
    gaps = [t1 - t0 for r in ctx.requests.values()
            for t0, t1 in zip(r.token_t, r.token_t[1:]) if a <= t1 < b]
    return {"rate": rate, "correct": bool(correct), "due": len(reqs),
            "completed_per_s": len(done) / ctx.window_s,
            "queue_open": ctx.extra.get("queue_open"),
            "queue_close": ctx.extra.get("queue_close"),
            "ttft_p50_ms": ttft(reqs, 50), "ttft_p90_ms": ttft(reqs, 90),
            "ttft_p90_first_third_ms": ttft(reqs[:third], 90),
            "ttft_p90_last_third_ms": ttft(reqs[-third:], 90),
            "itl_p50_ms": 1e3 * stats.percentile(gaps, 50),
            "itl_p95_ms": 1e3 * stats.percentile(gaps, 95)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(at_rate(args.workload, rate, args.seconds,
                                 args.seed)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

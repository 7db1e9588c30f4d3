#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``.  The run draws its
weights and traffic from ``--seed``, warms up every shape the cell uses,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, from a
profiled segment after the window), ``device`` and, last, ``checks``:
each number compared beside its limit, which also end standard error.
It exits non-zero and prints no result without enough CUDA devices, or
if the process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi gave no output"


def execute(ctx: harness.Context) -> dict:
    """Drive the cell and read its metrics -> the result line's dict."""
    bench = harness.benchmark()
    correct = harness.driver(ctx.cell["driver"]).run(ctx)
    metrics = {}
    for m in harness.cell_metrics(bench, ctx.cell_name, ctx.trace):
        value = harness.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": _device_name(ctx), "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": device}
    if ctx.profile is not None:
        device["busy_s"] = ctx.profile.busy_s
        device["window_s"] = ctx.profile.window_s
        out["breakdown"] = {"device_ops": ctx.profile.device_ops(10),
                            "idle_gaps": ctx.profile.idle_gaps}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in ctx.checks.items()}
    return out


def _device_name(ctx) -> str:
    import torch
    if ctx.device.type == "cuda":
        return torch.cuda.get_device_name(ctx.device)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell, conf, mix = harness.load(args.workload, harness.benchmark())
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    # one process, one host thread for torch's CPU ops: the serving loop's
    # host work is small ops whose pool wake-ups only add jitter
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    torch.cuda.init()
    ctx = harness.Context(args.workload, cell, conf, mix, args.seed,
                          args.seconds,
                          bool(args.trace), device=torch.device("cuda", 0),
                          model_cfg=harness.model_config(conf),
                          t_start=T_START)
    ctx.stamp("cuda")
    result = execute(ctx)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}, which no benchmark run "
              f"may load", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {_card()}; "
          f"{json.dumps(ctx.extra)}", file=sys.stderr)
    for k, v in ctx.checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

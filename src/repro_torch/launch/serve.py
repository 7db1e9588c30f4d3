"""Serving entry point: low-batch decode with the layer-stepped engine
(fused segments, chunked admission, continuous batching, Algorithm-2
token buffering); port of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --reduced --device cpu --requests 6 --max-new 16 --slack 0.2

Closed-loop traffic (``--traffic``) drives the continuous-batching
scheduler with Poisson arrivals: requests wait in a bounded queue
(``--queue-capacity``, ``--queue-policy``), prompts prefill in
``--chunk-tokens``-token chunks piggybacked on the decode batch, and the
run reports TTFT / TPOT / queue-delay p50/p95/p99 on the wall clock (the
iteration clock under ``--dry-run``) and on the modeled chiplet clock.
``--prefix-cache`` admits prompts that share a cached prefix with its
pages attached, and ``--preempt-depth`` lets the scheduler evict a running
request to the state pool when the queue is deeper:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --reduced --device cpu --traffic --traffic-requests 32 \\
      --traffic-rate 0.8 --chunk-tokens 8 --traffic-mix poisson+zipf_prefix \\
      --prefix-cache --preempt-depth 0

``--arch`` takes every registered config but the encoder-decoder one
(``whisper-base``), which the engine does not serve; the MoE archs
(granite, the paper's DeepSeek-MoE-16B, Qwen3-30B-A3B, Yuan2-M32 and
Phi-3.5-MoE, Jamba) name ``fse_dp`` in their full configs and serve under
``--strategy`` (``capacity`` by default).

The engine runs its fused segments (CUDA graphs on the card).  Weights
are random, drawn from ``--seed``.  ``--device`` defaults to ``cuda``
(and fails where there is none).  MoE execution is one
:class:`ExecutionSpec`: ``--strategy`` names a registered strategy
(``capacity``, ``dense`` or ``hybrid``; ``--hot-experts`` sets hybrid's
fast-tier width), ``--moe-spec path.json`` loads a full spec
(``"sorted_dispatch": true`` there turns on sorted dispatch), and
``--autotune {off,analytic,measured}`` overrides the spec's tile-planner
level (``core.autotune``; the engine's default is ``analytic``;
``measured`` times the kernel's tile settings on the card once per shape
and keeps the winners in ``kernel_tiles_torch.json`` under
``REPRO_AUTOTUNE_CACHE`` or ``artifacts/autotune/``).
``--resident-budget-mb`` pins each MoE layer's EMA-hottest experts on
the modeled package (accounting only: the same tokens); every run prints
the weight tier's resident bytes and the DDR bytes it saved:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --reduced --device cpu --dry-run --strategy hybrid --hot-experts 4 \\
      --resident-budget-mb 0.1
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def build_spec(args):
    from repro_torch.core.strategy import ExecutionSpec
    if args.moe_spec:
        spec = ExecutionSpec.load(args.moe_spec)
        if args.strategy:
            spec = dataclasses.replace(spec, strategy=args.strategy)
    else:
        spec = ExecutionSpec(strategy=args.strategy or "capacity")
    if args.schedule:
        spec = dataclasses.replace(spec, schedule=args.schedule)
    if args.weight_dtype:
        spec = dataclasses.replace(spec, weight_dtype=args.weight_dtype)
    if args.autotune:
        spec = dataclasses.replace(spec, autotune=args.autotune)
    return spec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slack", type=float, default=0.0)
    ap.add_argument("--theta-min", type=int, default=2)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--strategy", default=None,
                    help="MoE execution strategy (capacity, dense or "
                         "hybrid); default capacity")
    ap.add_argument("--moe-spec", default=None,
                    help="path to an ExecutionSpec JSON; --strategy "
                         "overrides its strategy field")
    ap.add_argument("--schedule", choices=("static", "dynamic"), default=None,
                    help="expert-trajectory scheduling; 'dynamic' follows "
                         "the EMA of observed gating counts")
    ap.add_argument("--weight-dtype", choices=("fp32", "bf16", "int8", "fp8"),
                    default=None,
                    help="streamed storage format of the expert weights")
    ap.add_argument("--autotune", choices=("off", "analytic", "measured"),
                    default=None,
                    help="override the spec's tile-planner level "
                         "(core.autotune); 'measured' times the kernel's "
                         "tile settings on the card and caches the winners "
                         "under artifacts/autotune/")
    ap.add_argument("--resident-budget-mb", type=float, default=0.0,
                    help="EMA-hot weight tier: MiB of expert weights pinned "
                         "on the modeled package, split evenly over the MoE "
                         "layers (each layer's hottest experts by EMA); "
                         "they skip their DDR stream in the modeled clock "
                         "and the trace. 0 disables the tier")
    ap.add_argument("--hot-experts", type=int, default=None,
                    help="hybrid strategy: fast-tier experts per MoE layer "
                         "(default: the top quartile, strategy.default_hot),"
                         " repartitioned every iteration off the EMA and "
                         "recorded in the trace")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the spec and serve one tiny request "
                         "(with --traffic: a tiny closed loop on the "
                         "iteration clock)")
    ap.add_argument("--traffic", action="store_true",
                    help="closed loop: Poisson arrivals through the "
                         "continuous-batching scheduler (chunked prefill)")
    ap.add_argument("--traffic-requests", type=int, default=32)
    ap.add_argument("--traffic-rate", type=float, default=0.5,
                    help="mean Poisson arrivals per clock unit")
    ap.add_argument("--traffic-mix", default="poisson",
                    help="'poisson' plus '+'-separated modifiers "
                         "'zipf_prefix' and 'diurnal'")
    ap.add_argument("--avg-prompt", type=int, default=12)
    ap.add_argument("--chunk-tokens", type=int, default=8,
                    help="prefill chunk size piggybacked per iteration")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--queue-policy", choices=("fcfs", "spf"),
                    default="fcfs")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per physical KV page in the state pool")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-hash prompt prefixes and admit shared "
                         "prefixes with their pages attached")
    ap.add_argument("--preempt-depth", type=int, default=None,
                    help="queue depth past which the scheduler preempts one "
                         "running request per step to the state pool "
                         "(default: never; 0 preempts whenever the queue "
                         "is non-empty and no slot is free)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build(args):
    """The spec, config and random weights the arguments name."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.device import resolve_device
    from repro_torch.models import api

    device = resolve_device(args.device)
    spec = build_spec(args)
    if ExecutionSpec.from_json(spec.to_json()) != spec:
        raise SystemExit(f"spec JSON round-trip mismatch: {spec}")
    spec.validate()
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(f"--arch {args.arch}: engine serves LM-family "
                         f"models (encoder-decoder ones score and decode "
                         f"through models.api)")
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    params = api.init_params(cfg, seed=args.seed, device=device)
    return {"spec": spec, "cfg": cfg, "params": params, "device": device}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, engine=None):
    """Serve the hand-fed batch and return a dict with the engine, this
    run's outputs and wall seconds.  ``engine`` serves again on an engine
    of an earlier run, whose graphs are captured already
    (``chip_smoke.py`` calls this directly)."""
    import numpy as np
    from repro_torch.serving import Engine, ServeConfig

    if engine is None:
        built = build(args)
    else:
        built = {"spec": engine.scfg.spec, "cfg": engine.cfg,
                 "params": engine.params, "device": engine.device}
    cfg = built["cfg"]
    tiers = dict(resident_budget_mb=args.resident_budget_mb,
                 hot_experts=args.hot_experts)
    if args.dry_run:
        scfg = ServeConfig(max_batch=2, max_ctx=16, spec=built["spec"],
                           **tiers)
        prompts, max_new = [[1, 2, 3, 4]], 2
    else:
        scfg = ServeConfig(max_batch=args.max_batch,
                           max_ctx=args.prompt_len + args.max_new + 8,
                           buffering_slack=args.slack,
                           theta_min=args.theta_min,
                           page_size=args.page_size, spec=built["spec"],
                           **tiers)
        rng = np.random.default_rng(args.seed)
        prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
                   for _ in range(args.requests)]
        max_new = args.max_new
    eng = engine or Engine(built["params"], cfg, scfg, device=built["device"])
    _sync(eng.device)
    t0 = time.perf_counter()
    rids = [eng.submit(prompt, max_new=max_new) for prompt in prompts]
    _sync(eng.device)
    t_sub = time.perf_counter()
    outs = eng.run(max_iterations=8 if args.dry_run else 10_000)
    _sync(eng.device)
    t1 = time.perf_counter()
    return {**built, "engine": eng, "outs": {r: outs[r] for r in rids},
            "prompts": prompts, "max_new": max_new, "seconds": t1 - t0,
            "submit_seconds": t_sub - t0}


def run_traffic(args, *, wall_clock=None, engine=None):
    """Drive a Poisson request stream through the scheduler until it
    drains.  The metric clock is the wall (``time.monotonic``), or the
    iteration count under ``--dry-run`` or ``wall_clock=False``; the
    modeled chiplet clock runs beside it.  Returns a dict with the
    engine, the closed loop's result, the stream and wall seconds."""
    from repro_torch.serving import (Engine, Scheduler, SchedulerConfig,
                                     ServeConfig, TrafficConfig,
                                     make_traffic, run_closed_loop)

    built = build(args) if engine is None else {
        "spec": engine.scfg.spec, "cfg": engine.cfg,
        "params": engine.params, "device": engine.device}
    cfg = built["cfg"]
    n_req = (args.traffic_requests if args.traffic_requests != 32
             else 4) if args.dry_run else args.traffic_requests
    max_prompt = max(2, min(args.avg_prompt * 2,
                            args.prompt_len + args.avg_prompt))
    tcfg = TrafficConfig(num_requests=n_req, rate=args.traffic_rate,
                         avg_prompt=args.avg_prompt, max_prompt=max_prompt,
                         min_new=2, max_new=args.max_new,
                         vocab=cfg.vocab_size, seed=args.seed,
                         mix=args.traffic_mix)
    traffic = make_traffic(tcfg)
    eng = engine or Engine(built["params"], cfg, ServeConfig(
        max_batch=args.max_batch, max_ctx=max_prompt + args.max_new + 1,
        buffering_slack=args.slack, theta_min=args.theta_min,
        chunk_tokens=args.chunk_tokens, page_size=args.page_size,
        prefix_cache=args.prefix_cache, preempt_queue_depth=args.preempt_depth,
        seed=args.seed, spec=built["spec"],
        resident_budget_mb=args.resident_budget_mb,
        hot_experts=args.hot_experts), device=built["device"])
    if wall_clock is None:
        wall_clock = not args.dry_run
    sched = Scheduler(eng, SchedulerConfig(
        queue_capacity=args.queue_capacity, policy=args.queue_policy),
        clock=time.monotonic if wall_clock else None)
    _sync(eng.device)
    t0 = time.perf_counter()
    res = run_closed_loop(sched, traffic)
    _sync(eng.device)
    return {**built, "engine": eng, "result": res, "traffic": traffic,
            "scheduler": sched, "seconds": time.perf_counter() - t0,
            "n_requests": n_req, "wall_clock": wall_clock}


def _print_traffic(res):
    m, eng = res["result"]["metrics"], res["engine"]
    unit = "s" if res["wall_clock"] else "iters"
    print(f"traffic: {m.completed} completed, "
          f"{len(res['result']['dropped'])} dropped, {m.rejected} rejected, "
          f"{m.iterations} iterations")
    for name, pct, pct_m in (("ttft", m.ttft, m.ttft_modeled),
                             ("tpot", m.tpot, m.tpot_modeled),
                             ("queue_delay", m.queue_delay,
                              m.queue_delay_modeled)):
        print(f"  {name:12s} p50={pct['p50']:.3f} p95={pct['p95']:.3f} "
              f"p99={pct['p99']:.3f} {unit}; modeled p50={pct_m['p50']:.6f} "
              f"p95={pct_m['p95']:.6f} s")
    s = eng.stats
    print(f"  throughput   {m.throughput:.2f} tok/{unit} "
          f"({m.tokens_emitted} tokens, {s['prefill_chunks']} prefill "
          f"chunks, {s['deferrals']} deferrals, {s['host_syncs']} host "
          f"syncs); wall {m.tokens_emitted / res['seconds']:.1f} tok/s on "
          f"{eng.device}")
    print(f"  state pool   peak {s['pool_peak_pages']}/{s['pool_pages']} "
          f"pages, {s['peak_resident_state_bytes']} peak resident bytes, "
          f"{s['cache_hits']} cache hits / {s['cache_misses']} misses "
          f"({s['prefill_tokens_saved']} prefill tokens saved), "
          f"{s['preemptions']} preemptions / {s['restores']} restores")
    print(f"  {_weight_tier(eng)}")


def _weight_tier(eng) -> str:
    s = eng.stats
    return (f"weight tier  {eng.scfg.spec.weight_dtype or eng.cfg.dtype} "
            f"weights, {s['resident_weight_bytes']} resident expert bytes "
            f"({eng._n_resident}/layer), {s['ddr_bytes_saved']} DDR bytes "
            f"saved")


def main(argv=None):
    args = parse_args(argv)
    if args.traffic:
        res = run_traffic(args)
        print(f"moe spec: {res['spec'].to_json()}")
        _print_traffic(res)
        m = res["result"]["metrics"]
        if args.dry_run:
            if m.completed < res["n_requests"]:
                raise SystemExit(f"traffic dry-run incomplete: "
                                 f"{m.completed}/{res['n_requests']}")
            if args.preempt_depth is not None and m.preemptions < 1:
                raise SystemExit("preemption smoke: --preempt-depth was set "
                                 "but no request was ever preempted (check "
                                 "--traffic-requests vs --max-batch)")
            print("traffic dry-run OK")
        return
    res = run(args)
    eng, outs, dt = res["engine"], res["outs"], res["seconds"]
    print(f"moe spec: {res['spec'].to_json()}")
    n = sum(len(t) for t in outs.values())
    if args.dry_run:
        if n < 1:
            raise SystemExit("dry-run emitted no tokens")
        print(f"dry-run OK: spec={eng.scfg.spec.to_json()} tokens={n}")
        print(f"  {_weight_tier(eng)}")
        return
    for rid, toks in outs.items():
        print(f"{rid}: {toks[:12]}{'...' if len(toks) > 12 else ''}")
    s = eng.stats
    print(f"tokens={n} iterations={s['iterations']} "
          f"deferrals={s['deferrals']} expert_loads={s['expert_loads']} "
          f"loads_saved={s['expert_loads_saved']} "
          f"dynamic_schedules={s['dynamic_schedules']} "
          f"host_syncs={s['host_syncs']} "
          f"throughput={n / dt:.1f} tok/s on {eng.device}")
    print(_weight_tier(eng))


if __name__ == "__main__":
    main()

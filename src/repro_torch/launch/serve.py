"""Serving entry point: low-batch decode with the layer-stepped engine and
Algorithm-2 token buffering (port of ``repro.launch.serve``, the
hand-fed batch and ``--dry-run``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --reduced --device cpu --requests 6 --max-new 16 --slack 0.2

Weights are random, drawn from ``--seed``.  ``--device`` defaults to
``cuda`` (and fails where there is none).  MoE execution is one
:class:`ExecutionSpec`: ``--strategy`` names a registered strategy
(``capacity`` or ``dense``), ``--moe-spec path.json`` loads a full spec.
Closed-loop traffic (``--traffic``) is later work (ROADMAP A.9).
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
                    help="MoE execution strategy (capacity or dense); "
                         "default capacity")
    ap.add_argument("--moe-spec", default=None,
                    help="path to an ExecutionSpec JSON; --strategy "
                         "overrides its strategy field")
    ap.add_argument("--schedule", choices=("static", "dynamic"), default=None,
                    help="expert-trajectory scheduling; 'dynamic' follows "
                         "the EMA of observed gating counts")
    ap.add_argument("--weight-dtype", choices=("fp32", "bf16", "int8", "fp8"),
                    default=None,
                    help="streamed storage format of the expert weights")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the spec and serve one tiny request")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(args):
    """Build the model and engine, serve the requests, and return a dict
    with the engine, outputs and wall seconds (``chip_smoke.py`` calls
    this directly)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.serving import Engine, ServeConfig

    device = resolve_device(args.device)
    spec = build_spec(args)
    if ExecutionSpec.from_json(spec.to_json()) != spec:
        raise SystemExit(f"spec JSON round-trip mismatch: {spec}")
    spec.validate()
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    params = api.init_params(cfg, seed=args.seed, device=device)
    if args.dry_run:
        scfg = ServeConfig(max_batch=2, max_ctx=16, spec=spec)
        prompts, max_new = [[1, 2, 3, 4]], 2
    else:
        scfg = ServeConfig(max_batch=args.max_batch,
                           max_ctx=args.prompt_len + args.max_new + 8,
                           buffering_slack=args.slack,
                           theta_min=args.theta_min, spec=spec)
        rng = np.random.default_rng(args.seed)
        prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
                   for _ in range(args.requests)]
        max_new = args.max_new
    eng = Engine(params, cfg, scfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for prompt in prompts:
        eng.submit(prompt, max_new=max_new)
    outs = eng.run(max_iterations=8 if args.dry_run else 10_000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"engine": eng, "outs": outs, "seconds": time.perf_counter() - t0,
            "spec": spec, "cfg": cfg, "params": params}


def main(argv=None):
    args = parse_args(argv)
    res = run(args)
    eng, outs, dt = res["engine"], res["outs"], res["seconds"]
    print(f"moe spec: {res['spec'].to_json()}")
    n = sum(len(t) for t in outs.values())
    if args.dry_run:
        if n < 1:
            raise SystemExit("dry-run emitted no tokens")
        print(f"dry-run OK: spec={eng.scfg.spec.to_json()} tokens={n}")
        return
    for rid, toks in outs.items():
        print(f"{rid}: {toks[:12]}{'...' if len(toks) > 12 else ''}")
    s = eng.stats
    print(f"tokens={n} iterations={s['iterations']} "
          f"deferrals={s['deferrals']} expert_loads={s['expert_loads']} "
          f"loads_saved={s['expert_loads_saved']} "
          f"dynamic_schedules={s['dynamic_schedules']} "
          f"throughput={n / dt:.1f} tok/s on {eng.device}")


if __name__ == "__main__":
    main()

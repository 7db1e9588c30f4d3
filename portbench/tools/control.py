#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers on
many seeds (the lower readings) and those of the controls and faults
(the upper ones), each judged by the cell's own check
(``serving.check_served`` or ``scoring_loop.check``) with the cell's
limits, so each comes out correct or not as a run would.

    python3 portbench/tools/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

In one process, for each seed: a run of the cell as the benchmark runs
it (the window at the cell's own load and size, then the comparison with
the reference), and on the same inputs:

- ``fp8_program``: the program's own fp8 path (``ExecutionSpec``
  ``weight_dtype="fp8"``: the expert weights quantized per call), the
  contract's control where a program has such a path.  A serving cell
  reads it at each position of the same prompts and served tokens (it
  need not decode): the token it puts first.  A scoring cell reads its
  loss, cross-entropy and load-balance term on the probe calls.  Its
  numbers are read with the precision check left out
  (``expert_weight_bits``, which it fails by construction), so they
  show what the comparison with the reference alone sees.
- ``fp8_reference``: the reference with every matrix product's operands
  rounded to fp8 (e4m3, per-row and per-column absmax scaling), read the
  same way.
- scoring only, faults of the timed path: ``fault_half_batch`` (half the
  batch left out, the mean taken over the rest), ``fault_moe_dropped``
  (every MoE layer's output left out), ``fault_answer_altered`` (the
  returned loss 1% off).

Prints one JSON line a seed: for the program and each control, whether
it came out correct and its compared numbers.  The benchmark's own runs
never run this.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import harness, serving, weights  # noqa: E402
from portbench.reference import lm as reference  # noqa: E402

E4M3_MAX = 448.0


def fp8(x, dim):
    """``x`` rounded to e4m3 with its absmax along ``dim`` scaled to 448."""
    import torch
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_mm(a, b):
    return fp8(a, -1) @ fp8(b, -2)


@contextlib.contextmanager
def fp8_reference():
    saved = reference.mm
    reference.mm = fp8_mm
    try:
        yield
    finally:
        reference.mm = saved


@contextlib.contextmanager
def moe_dropped():
    """Every MoE layer's output left out (its load-balance term kept)."""
    from repro_torch.models import moe
    saved = moe.moe_block

    def dropped(*a, **k):
        out = saved(*a, **k)
        if isinstance(out, tuple):
            return (out[0] * 0,) + tuple(out[1:])
        return out * 0
    moe.moe_block = dropped
    try:
        yield
    finally:
        moe.moe_block = saved


def judged(ctx, name: str, run) -> dict:
    """``run(c)`` judges a control on a copy ``c`` of the run's context
    -> whether it came out correct, and its compared numbers."""
    c = dataclasses.replace(ctx, checks={}, extra={})
    ok = run(c)
    return {"correct": bool(ok),
            "checks": {k: v["value"] for k, v in c.checks.items()}}


def serving_readings(ctx) -> dict:
    """Each control's first tokens at the positions of the program's
    served tokens, judged by ``serving.check_served``."""
    import torch
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import transformer
    sample = serving.sample_finished(ctx, list(ctx.requests.values()),
                                     int(ctx.cell["check"]["min_tokens"]))
    prompts = [r.prompt for r in sample]
    served = [r.tokens for r in sample]
    w = weights.draw(ctx.model_cfg, ctx.seed, ctx.device)
    cfg = ctx.model_cfg
    # the engine serves drop-free: capacity E rows an expert's share
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    picks = {}
    with torch.no_grad():
        spec = ExecutionSpec(strategy="capacity", weight_dtype="fp8")
        firsts = []
        for p, s in zip(prompts, served):
            tok = torch.tensor([p + s[:-1]], device=ctx.device)
            lg, _ = transformer.forward(w, tok, cfg, spec=spec)
            firsts.append(lg[0, len(p) - 1:].float().argmax(-1).tolist())
            del lg
        picks["fp8_program"] = firsts
        with fp8_reference():
            low = reference.served_logits(w, ctx.conf, prompts, served)
        picks["fp8_reference"] = [z.argmax(-1).tolist() for z in low]
    del w, low
    torch.cuda.empty_cache()
    return {name: judged(ctx, name, lambda c, t=t: serving.check_served(
        c, sample, t)) for name, t in picks.items()}


def scoring_readings(ctx) -> dict:
    """Each control's and fault's (loss, ce, aux) on the probe calls,
    judged by ``scoring_loop.check``."""
    import torch
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import api
    from portbench.drivers import scoring_loop
    cfg = ctx.model_cfg
    cf = float(ctx.conf["capacity_factor"])
    coef = float(ctx.conf["router_aux_loss_coef"])
    probe = {i: keep for i, keep in scoring_loop.probes(ctx).items()
             if i < len(ctx.calls)}
    w = weights.draw(cfg, ctx.seed, ctx.device)

    def program(batch, **kw):
        loss, parts = api.loss_fn(w, batch, cfg, use_flash=True, **kw)
        return (float(loss), float(parts["ce"]), float(parts["aux"]))

    def reference_fp8(batch):
        with fp8_reference():
            ce, aux = reference.score_terms(w, ctx.conf, batch["tokens"],
                                            batch["labels"], cf)
        return (ce + coef * aux, ce, aux)

    def half(batch):
        return program({k: v[:v.shape[0] // 2] for k, v in batch.items()})

    def dropped(batch):
        with moe_dropped():
            return program(batch)

    spec8 = ExecutionSpec(strategy=cfg.moe.impl, weight_dtype="fp8")
    paths = {"fp8_program": lambda b: program(b, spec=spec8),
             "fp8_reference": reference_fp8,
             "fault_half_batch": half,
             "fault_moe_dropped": dropped}
    outs = {name: [None] * len(ctx.calls) for name in paths}
    with torch.no_grad():
        for i, keep in probe.items():
            b = scoring_loop._batch(ctx, i, keep)
            for name, f in paths.items():
                outs[name][i] = f(b)
    del w
    torch.cuda.empty_cache()
    outs["fault_answer_altered"] = [
        None if x is None else (x[0] * 1.01, x[1], x[2]) for x in ctx.calls]
    return {name: judged(ctx, name, lambda c, o=o: scoring_loop.check(c, o))
            for name, o in outs.items()}


def reading(cell_name: str, seed: int, seconds: float):
    """One run of the cell as the benchmark runs it -> (its result, its
    context)."""
    import torch
    cell, conf, mix = harness.load(cell_name, harness.benchmark())
    ctx = harness.Context(cell_name, cell, conf, mix, seed, seconds, False,
                          device=torch.device("cuda", 0),
                          model_cfg=harness.model_config(conf),
                          t_start=harness.now())
    t0 = time.perf_counter()
    correct = harness.driver(cell["driver"]).run(ctx)
    out = {"workload": cell_name, "seed": seed, "correct": bool(correct),
           "seconds": time.perf_counter() - t0,
           "checks": {k: v["value"] for k, v in ctx.checks.items()}}
    return out, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        out, ctx = reading(args.workload, seed, args.seconds)
        t0 = time.perf_counter()
        if ctx.cell["driver"] == "scoring_loop":
            out["controls"] = scoring_readings(ctx)
        else:
            out["controls"] = serving_readings(ctx)
        out["control_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

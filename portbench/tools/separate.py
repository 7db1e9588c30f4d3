#!/usr/bin/env python3
"""Which numbers tell the program's bf16 path from its fp8 expert path,
against the reference, at a cell's widths (teacher forced, no window).

    python3 portbench/tools/separate.py --config deepseek-moe-16b \
        --seeds 1,2 --seqs 4 --len 320

Prints one JSON line a seed and path: per layer, the share of routed
(token, expert) choices that differ from the reference's; and the logit
errors per position (the RMS over the vocabulary, the argmax agreement,
the gap of the program's argmax, and the error of the cross-entropy of a
random label).
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import harness, weights  # noqa: E402
from portbench.reference import lm as reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seqs", type=int, default=4)
    ap.add_argument("--len", type=int, default=320)
    ap.add_argument("--capacity", type=float, default=0.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    from repro_torch.core import gating
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import transformer
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    conf = harness.config(args.config)
    cfg = harness.model_config(conf)
    cf = args.capacity or None
    if cf is None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    else:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    L, k = cfg.num_layers, cfg.moe.top_k
    routes = []
    orig = gating.route

    def spy(params, x, **kw):
        r = orig(params, x, **kw)
        routes.append(r.indices.detach())
        return r
    gating.route = spy
    for seed in (int(s) for s in args.seeds.split(",")):
        w = weights.draw(cfg, seed, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        tok = torch.randint(0, cfg.vocab_size, (args.seqs, args.len),
                            generator=g, device=dev)
        lab = torch.randint(0, cfg.vocab_size, (args.seqs * args.len,),
                            generator=g, device=dev)
        with torch.no_grad():
            reference.ROUTES = []
            hid, _ = reference.hidden(w, conf, tok.tolist(), cf)
            ref_routes = torch.stack(reference.ROUTES)      # (L, T, k)
            reference.ROUTES = None
            rows = torch.arange(hid.shape[0], device=dev)
            zr = reference.logits_at(w, hid, rows)
            del hid
            lse_r = torch.logsumexp(zr, -1)
            ce_r = lse_r - zr.gather(1, lab[:, None])[:, 0]
            am_r = zr.argmax(-1)
            for name, spec in (("bf16", ExecutionSpec(strategy="capacity")),
                               ("fp8", ExecutionSpec(strategy="capacity",
                                                     weight_dtype="fp8"))):
                routes.clear()
                # drop-free: one sequence a call; with a capacity, the
                # whole batch in one call, as the scoring path routes it
                parts = [tok[b:b + 1] for b in range(args.seqs)] \
                    if cf is None else [tok]
                zs = []
                for t in parts:
                    lg, _ = transformer.forward(w, t, cfg, spec=spec,
                                                use_flash=cf is not None)
                    zs.append(lg.reshape(-1, lg.shape[-1]).float())
                    del lg
                zp = torch.cat(zs)
                del zs
                n = len(parts)
                pr = torch.stack([torch.cat([routes[b * L + l]
                                             for b in range(n)])
                                  for l in range(L)])
                onehot = lambda r: torch.zeros(  # noqa: E731
                    (*r.shape[:2], cfg.moe.num_experts), device=dev
                ).scatter_(2, r, 1.0)
                miss = 1 - (onehot(pr) * onehot(ref_routes)).sum(-1) / k
                e = zp - zr
                rms = e.pow(2).mean(-1).sqrt()
                am_p = zp.argmax(-1)
                gap = zr.max(-1).values - zr.gather(1, am_p[:, None])[:, 0]
                ce_p = torch.logsumexp(zp, -1) - zp.gather(1, lab[:, None])[:, 0]
                dce = (ce_p - ce_r).abs()
                q = lambda v, p: float(torch.quantile(  # noqa: E731
                    v.float()[:100000], p))
                out = {"config": args.config, "seed": seed, "path": name,
                       "route_miss_by_layer": [round(float(m), 5) for m in
                                               miss.mean(-1)],
                       "route_miss_tokens_any_by_layer": [
                           round(float(m), 5) for m in
                           (miss > 0).float().mean(-1)],
                       "logit_rms": {"mean": float(rms.mean()),
                                     "p50": q(rms, 0.5), "p90": q(rms, 0.9)},
                       "share_off": float((am_p != am_r).float().mean()),
                       "gap": {"mean": float(gap.mean()),
                               "p90": q(gap, 0.9)},
                       "dce": {"mean": float(dce.mean()),
                               "rms": float(dce.pow(2).mean().sqrt()),
                               "p50": q(dce, 0.5), "p90": q(dce, 0.9)},
                       "dce_mean_signed": float((ce_p - ce_r).mean())}
                print(json.dumps(out), flush=True)
                del zp, e
        del w, zr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

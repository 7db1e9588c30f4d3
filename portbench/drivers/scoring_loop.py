"""Scoring loop: back-to-back calls of ``repro_torch.models.api.loss_fn``
(the flash kernel on, the configuration's own MoE spec), each on a new
batch of ``batch`` x ``seq`` uniformly random tokens drawn on the device
from (seed, call), labels the tokens shifted by one (the last not
scored).  One call is in flight while the next is queued, so the card
never waits on the host between calls.  Two calls warm up (kernels
loaded, workspaces allocated); the window is a whole number of calls,
from the first call's launch to the end of the call that ends past
``--seconds``.

``correct`` compares what a sample of the window's calls returned with
the reference's: ``calls`` probe calls drawn from the seed among the
window's first ``among_first``.  A probe call runs the same tokens
through the same work, but scores only ``positions`` of them (drawn
from the seed; every other label -1, which ``loss_fn`` masks after
computing every position's logits), so its cross-entropy carries the
error of a few tokens instead of the mean over 4,094, in which the
per-token errors of the logits cancel.  Compared, each by its widest
gap over the probes: the loss, its cross-entropy and its load-balance
term (over all tokens, whatever the labels), against the limits the
cell's ``check`` gives (``max_<term>_gap``)."""
import gc

import numpy as np

from portbench import harness, profiling, weights
from portbench.reference import lm as reference


def probes(ctx) -> dict:
    """{call index: the flat positions it scores} of the probe calls,
    drawn from the seed."""
    chk = ctx.cell["check"]
    B, S = int(ctx.mix["batch"]), int(ctx.mix["seq"])
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(ctx.seed) & (2 ** 64 - 1), 11]))
    calls = rng.permutation(int(chk["among_first"]))[:int(chk["calls"])]
    # the last position of each row has no label
    scored = [b * S + j for b in range(B) for j in range(S - 1)]
    return {int(i): sorted(rng.choice(scored, int(chk["positions"]),
                                      replace=False).tolist())
            for i in sorted(calls)}


def _batch(ctx, i: int, keep=None):
    """Call ``i``'s tokens and labels; with ``keep`` (flat positions),
    only those are scored."""
    import torch
    p = ctx.mix
    B, S = int(p["batch"]), int(p["seq"])
    g = torch.Generator(device=ctx.device)
    g.manual_seed((int(ctx.seed) * 1_000_003 + i) & (2 ** 63 - 1))
    tokens = torch.randint(0, ctx.model_cfg.vocab_size, (B, S), generator=g,
                           device=ctx.device)
    labels = torch.cat([tokens[:, 1:], torch.full((B, 1), -1,
                                                  device=ctx.device)], dim=1)
    if keep is not None:
        flat = torch.full((B * S,), -1, dtype=labels.dtype, device=ctx.device)
        idx = torch.as_tensor(keep, device=ctx.device)
        flat[idx] = labels.reshape(-1)[idx]
        labels = flat.view(B, S)
    return {"tokens": tokens, "labels": labels}


def run(ctx: harness.Context) -> bool:
    import torch
    from repro_torch.core.strategy import ExecutionSpec
    from repro_torch.models import api
    cuda = ctx.device.type == "cuda"
    cfg = ctx.model_cfg

    def sync():
        if cuda:
            torch.cuda.synchronize()

    weights.layout(cfg)
    ctx.stamp("imported")
    params = weights.draw(cfg, ctx.seed, ctx.device)
    sync()
    ctx.stamp("weights")
    ctx.check("expert_weight_bits", harness.weight_bits(
        cfg, ExecutionSpec.coerce(None, default=cfg.moe.impl)),
        harness.stated_bits(ctx.conf), bad_when="below")
    probe = probes(ctx)
    losses, pending = [], []

    def call(i: int) -> None:
        with torch.no_grad(), \
                torch.profiler.record_function("portbench.loss_fn"):
            loss, parts = api.loss_fn(params, _batch(ctx, i, probe.get(i)),
                                      cfg, use_flash=True)
            losses.append(torch.stack([loss, parts["ce"], parts["aux"]])
                          .float())
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            if pending:
                pending.pop().synchronize()
            pending.append(ev)

    for i in range(2):
        call(-1 - i)
    sync()
    ctx.stamp("warm")
    losses.clear()
    pending.clear()
    t_open = harness.now()
    n = 0
    while True:
        call(n)
        n += 1
        if harness.now() - t_open >= ctx.seconds:
            break
    sync()
    ctx.window = (t_open, harness.now())
    # (loss, ce, aux) of each call in the window
    ctx.calls = torch.stack(losses).cpu().tolist()
    if ctx.trace:
        k = [n]

        def step():
            call(k[0])
            k[0] += 1
        ctx.profile = profiling.profile(step, int(ctx.cell["profile_calls"]),
                                        profiling.port_kernels(harness.ROOT),
                                        sync)
        ctx.profile.steps = list(range(int(ctx.cell["profile_calls"])))
    if cuda:
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    ctx.attempted = n
    ctx.failed = sum(1 for x in ctx.calls if not np.all(np.isfinite(x)))
    del params, losses, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return check(ctx) and ctx.failed == 0


TERMS = ("loss", "ce", "aux")


def check(ctx: harness.Context, calls=None) -> bool:
    """The reference's loss, cross-entropy and load-balance term on the
    probe calls the window made, against ``calls`` ((loss, ce, aux) by
    call index; by default what the window's calls returned), each by
    its widest gap, for each term the cell's check gives a limit
    (``max_<term>_gap``); and every other check of the run must hold.  A
    window that made no probe call is not correct."""
    import torch
    calls = ctx.calls if calls is None else calls
    chk = ctx.cell["check"]
    pick = {i: keep for i, keep in probes(ctx).items() if i < len(calls)}
    t0 = harness.now()
    w = weights.draw(ctx.model_cfg, ctx.seed, ctx.device)
    coef = float(ctx.conf["router_aux_loss_coef"])
    gaps = {t: [] for t in TERMS}
    with torch.no_grad():
        for i, keep in pick.items():
            b = _batch(ctx, i, keep)
            ce, aux = reference.score_terms(w, ctx.conf, b["tokens"],
                                            b["labels"],
                                            float(ctx.conf["capacity_factor"]))
            for t, got, want in zip(TERMS, calls[i],
                                    (ce + coef * aux, ce, aux)):
                gaps[t].append(got - want)
    del w
    ctx.extra.update(reference_s=harness.now() - t0, signed_gaps=gaps,
                     probe_calls=sorted(pick))
    for t in TERMS:
        lim = chk["limits"].get(f"max_{t}_gap")
        if lim is not None:
            ctx.check(f"max_{t}_gap",
                      max((abs(g) for g in gaps[t]), default=np.inf), lim)
    return bool(pick) and all(c["ok"] for c in ctx.checks.values())

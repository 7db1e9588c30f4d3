"""Open loop: requests arrive on a schedule drawn from the seed (Poisson at
the cell's fixed ``rate``, optionally cycled by ``diurnal``), whether or
not earlier ones have finished.  A few warm-up requests are served
first, which captures every CUDA graph (prefill chunk and decode
segments: their batch shape is fixed); then the arrivals start,
``preroll_s`` before the window opens, so the window sees a queue in
its steady state.  Each request is timed from when it was due; the loop
offers every due request before each scheduler step, and sleeps only
when nothing is pending.  After the window no new request is offered,
and the loop serves on until every request due in the window has its
first token (at most ``drain_s``): a late answer is late, not wrong."""
import time

import numpy as np

from portbench import harness, profiling, serving
from portbench import traffic as tr


def run(ctx: harness.Context) -> bool:
    p = ctx.mix
    V = ctx.model_cfg.vocab_size
    srv = serving.Server(ctx)

    stream = tr.Traffic(p, ctx.seed, V)
    preroll = float(p["preroll_s"])
    horizon = preroll + ctx.seconds + float(ctx.cell["drain_s"])
    gaps = stream.arrivals(int(float(p["rate"]) * horizon * 1.5) + 16)
    stream.prefetch(len(gaps))
    ctx.stamp("traffic")
    warm = tr.Traffic(p, ctx.seed + 1, V)
    warm_reqs = []
    for i in range(int(ctx.cell["warmup_requests"])):
        r = warm.request(i)
        warm_reqs.append(serving.Req(-1 - i, harness.now(), r.prompt,
                                     r.max_new))
        srv.offer(warm_reqs[-1])
    while srv.pending():
        srv.step()
    ctx.stamp("warm")

    origin = harness.now()
    t_open = origin + preroll
    t_close = t_open + ctx.seconds
    due = origin + gaps
    issued = []

    def loop_once(offer_before: float) -> bool:
        """Offer what is due, then one scheduler step, or a short sleep
        when nothing is pending -> whether a step ran."""
        t = harness.now()
        while len(issued) < len(due) and due[len(issued)] <= t \
                and due[len(issued)] < offer_before:
            r = stream.request(len(issued))
            req = serving.Req(r.index, float(due[len(issued)]), r.prompt,
                              r.max_new)
            issued.append(req)
            srv.offer(req)
        if srv.pending():
            srv.step()
            return True
        if len(issued) < len(due):
            time.sleep(min(1e-3, max(0.0, due[len(issued)] - t)))
        return False

    def one_step() -> None:
        """Serve on, arrivals still offered, until a scheduler step ran."""
        while not loop_once(np.inf):
            pass

    while harness.now() < t_open:
        loop_once(t_close)
    srv.sync()
    ctx.counters["open"] = srv.counters()
    ctx.extra["queue_open"] = srv.sched.queue_depth()
    while harness.now() < t_close:
        loop_once(t_close)
    ctx.window = (t_open, t_close)
    ctx.counters["close"] = srv.counters()
    ctx.extra["queue_close"] = srv.sched.queue_depth()
    if ctx.trace:
        n = len(ctx.steps) + 2
        ctx.profile = profiling.profile(
            one_step, int(ctx.cell["profile_steps"]),
            profiling.port_kernels(harness.ROOT), srv.sync)
        ctx.profile.steps = ctx.steps[n:]
    in_window = [r for r in issued if t_open <= r.due < t_close]
    give_up = max(harness.now(), t_close) + float(ctx.cell["drain_s"])
    while harness.now() < give_up and srv.pending() and any(
            r.rid is not None and not r.token_t for r in in_window):
        srv.step()
    ctx.attempted = len(in_window)
    ctx.failed = sum(1 for r in in_window if r.rid is None or not r.token_t)
    ctx.requests = {r.index: r for r in issued}
    sample = serving.sample_finished(ctx, issued,
                                     int(ctx.cell["check"]["min_tokens"]))
    srv.finish()
    return serving.check_served(ctx, sample) and ctx.failed == 0

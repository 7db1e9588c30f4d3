"""Closed loop: ``clients`` clients, each sending its next request as soon
as its last one completes, so the batch stays as full as the clients
keep it.  The clients are running before the window opens (``warmup_s``
of serving, every CUDA graph captured in its first iterations), and the
window is a whole number of scheduler steps: from the first step's start
after the warm-up to the end of the first step that ends past
``--seconds``.  Requests draw from the cell's traffic block in the
order the clients ask (the first ``requests_ahead`` drawn in set-up);
``correct`` compares a sample of the finished
requests (``serving.check_served``)."""
from portbench import harness, profiling, serving
from portbench import traffic as tr


def run(ctx: harness.Context) -> bool:
    p = ctx.mix
    srv = serving.Server(ctx)
    stream = tr.Traffic(p, ctx.seed, ctx.model_cfg.vocab_size)
    stream.prefetch(int(ctx.cell["requests_ahead"]))
    issued = []
    current = {}

    def start(client: int) -> None:
        r = stream.request(len(issued))
        req = serving.Req(r.index, harness.now(), r.prompt, r.max_new)
        issued.append(req)
        current[client] = req
        srv.offer(req)

    def loop_once() -> None:
        for c, req in list(current.items()):
            if req.done_t is not None or req.rid is None:
                start(c)
        srv.step()

    ctx.stamp("engine")
    for c in range(int(p["clients"])):
        start(c)
    t_warm = harness.now() + float(ctx.cell["warmup_s"])
    while harness.now() < t_warm:
        loop_once()
    srv.sync()
    ctx.stamp("warm")
    ctx.counters["open"] = srv.counters()
    first = len(ctx.steps)
    t_open = harness.now()
    while harness.now() - t_open < ctx.seconds:
        loop_once()
    ctx.window = (t_open, ctx.steps[-1].t1)
    ctx.counters["close"] = srv.counters()
    ctx.extra["window_steps"] = len(ctx.steps) - first
    if ctx.trace:
        n = len(ctx.steps) + 2
        ctx.profile = profiling.profile(
            loop_once, int(ctx.cell["profile_steps"]),
            profiling.port_kernels(harness.ROOT), srv.sync)
        ctx.profile.steps = ctx.steps[n:]
    offered = [r for r in issued if r.offered < ctx.window[1]]
    ctx.attempted = len(offered)
    ctx.failed = sum(1 for r in offered if r.rid is None)
    ctx.requests = {r.index: r for r in issued}
    sample = serving.sample_finished(ctx, issued,
                                     int(ctx.cell["check"]["min_tokens"]))
    srv.finish()
    return serving.check_served(ctx, sample) and ctx.failed == 0

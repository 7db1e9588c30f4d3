"""itl_p95_ms: the 95th percentile of every gap between two consecutive
output tokens of a request whose later token came in the window, over
all requests."""
from portbench.stats import percentile


def read(ctx):
    a, b = ctx.window
    gaps = [t1 - t0 for r in ctx.requests.values()
            for t0, t1 in zip(r.token_t, r.token_t[1:]) if a <= t1 < b]
    return 1e3 * percentile(gaps, 95) if gaps else None

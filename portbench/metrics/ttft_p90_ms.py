"""ttft_p90_ms: the 90th percentile, over every request due in the window,
of the time from when it was due to its first token.  A request refused
or never answered counts as the time until the drain gave up on it."""
from portbench.readers import due_in_window
from portbench.stats import percentile


def read(ctx):
    reqs = due_in_window(ctx)
    if not reqs:
        return None
    end = max(s.t1 for s in ctx.steps)
    return 1e3 * percentile([(r.token_t[0] if r.token_t else end) - r.due
                             for r in reqs], 90)

"""offer_lag_p90_ms.chat: 90th percentile of how late the benchmark's
loop offered a request after it was due (the loop offers between
scheduler steps), over the requests due in the window."""
from portbench.readers import due_in_window
from portbench.stats import percentile


def read(ctx):
    lags = [r.offered - r.due for r in due_in_window(ctx) if r.offered]
    return 1e3 * percentile(lags, 90) if lags else None

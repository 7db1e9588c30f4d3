"""queue_wait_p90_ms.chat: 90th percentile of the scheduler's own queue
wait (its tickets' admission stamp minus their arrival stamp) over the
requests due in the window that it admitted."""
from portbench.readers import due_in_window
from portbench.stats import percentile


def read(ctx):
    waits = [r.admitted - r.arrival for r in due_in_window(ctx)
             if r.admitted is not None and r.arrival is not None]
    return 1e3 * percentile(waits, 90) if waits else None

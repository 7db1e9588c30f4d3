"""sync_wait_ms.decode: milliseconds an iteration the host blocks in the
synchronize of the fused engine's fetches (``MegaStep.fetch``), waiting
for the segments queued before it (``sync_wait_ns``), over the window's
iterations.  None where the program keeps no such counter."""
from portbench.readers import counter_delta


def read(ctx):
    try:
        n = counter_delta(ctx, "iterations")
        ns = counter_delta(ctx, "sync_wait_ns")
    except KeyError:
        return None
    return ns / n / 1e6 if n else None

"""host_exposed_ms.<cell>: the engine's host milliseconds an iteration
with nothing of its own to wait for: every ``Engine.step`` call, whole
(``step_ns``), less the time blocked in the fetches' synchronize
(``sync_wait_ns``), over the window's iterations.  None where the
program keeps no such counters."""
from portbench.readers import counter_delta


def read(ctx):
    try:
        n = counter_delta(ctx, "iterations")
        ns = counter_delta(ctx, "step_ns") - counter_delta(ctx,
                                                           "sync_wait_ns")
    except KeyError:
        return None
    return ns / n / 1e6 if n else None

"""boundary_host_ms.decode: milliseconds an iteration of host work at the
MoE boundaries, from a boundary's fetch returning to the call of the
segment after it (``boundary_host_ns``: EMA, trace record, deferral
sweep, the next segment's inputs), over the window's iterations.  None
where the program keeps no such counter."""
from portbench.readers import counter_delta


def read(ctx):
    try:
        n = counter_delta(ctx, "iterations")
        ns = counter_delta(ctx, "boundary_host_ns")
    except KeyError:
        return None
    return ns / n / 1e6 if n else None

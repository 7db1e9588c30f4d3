"""host_syncs_per_iter.decode: the engine's host syncs over its iterations
in the window (``Engine.stats``)."""
from portbench.readers import counter_delta


def read(ctx):
    n = counter_delta(ctx, "iterations")
    return counter_delta(ctx, "host_syncs") / n if n else None

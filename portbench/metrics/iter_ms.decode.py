"""iter_ms.decode: the window's milliseconds over the engine's iterations
in it (``Engine.stats["iterations"]``)."""
from portbench.readers import counter_delta


def read(ctx):
    n = counter_delta(ctx, "iterations")
    return 1e3 * ctx.window_s / n if n else None

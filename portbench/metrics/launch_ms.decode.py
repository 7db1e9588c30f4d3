"""launch_ms.decode: milliseconds an iteration the host spends starting
segments whose CUDA graphs are built: staging the inputs and the graph
replay (``launch_ns``; captures are not in it), over the window's
iterations.  None where the program keeps no such counter."""
from portbench.readers import counter_delta


def read(ctx):
    try:
        n = counter_delta(ctx, "iterations")
        ns = counter_delta(ctx, "launch_ns")
    except KeyError:
        return None
    return ns / n / 1e6 if n else None

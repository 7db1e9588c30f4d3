"""prefill_iter_ms.chat: the summed wall time of the window's scheduler
steps that carried a prefill chunk (the engine's ``prefill_chunks``
counter moved), over their count."""
from portbench.readers import window_steps


def read(ctx):
    steps = [s for s in window_steps(ctx) if s.stats["prefill_chunks"] > 0]
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps)

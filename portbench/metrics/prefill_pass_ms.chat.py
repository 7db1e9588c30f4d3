"""prefill_pass_ms.chat: the host milliseconds of one prefill chunk pass
of the fused engine, whole (set, stage, replay, fetch, the per-layer
records, first tokens, prefix registration): ``prefill_pass_ns`` over
``prefill_passes`` in the window.  None where the program keeps no such
counters, or ran no pass in the window."""
from portbench.readers import counter_delta


def read(ctx):
    try:
        n = counter_delta(ctx, "prefill_passes")
        ns = counter_delta(ctx, "prefill_pass_ns")
    except KeyError:
        return None
    return ns / n / 1e6 if n else None

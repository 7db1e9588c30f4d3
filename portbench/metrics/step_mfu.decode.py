"""step_mfu.decode: the least time the card could take for the window's
serving iterations (each the larger of its operations over the bf16 peak
and its needed bytes over HBM bandwidth, ``roofline.decode_step``),
summed over the window's steps, over the window, in %."""
from collections import defaultdict

from portbench import roofline
from portbench.readers import window_steps


def read(ctx):
    steps = window_steps(ctx)
    if not steps:
        return None
    shape = roofline.Shape(ctx.conf)
    least = 0.0
    for s in steps:
        used = defaultdict(set)
        for layer, _, counts in s.records:
            used[layer].update(int(e) for e in counts.nonzero()[0])
        ops, moved = roofline.decode_step(
            shape, s.decode_ctx, s.stats["prefill_tokens"],
            sum(len(v) for v in used.values()), s.stats["tokens_emitted"])
        least += roofline.bound_s(ops, moved)
    return 100.0 * least / ctx.window_s

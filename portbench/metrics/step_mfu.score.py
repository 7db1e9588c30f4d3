"""step_mfu.score: the model operations of the window's scoring calls
(``roofline.score_call_flops``) over the window's seconds times the
card's bf16 peak, in %."""
from portbench import roofline


def read(ctx):
    if not ctx.calls:
        return None
    p = ctx.mix
    ops = len(ctx.calls) * roofline.score_call_flops(
        roofline.Shape(ctx.conf), int(p["batch"]), int(p["seq"]))
    return 100.0 * ops / (ctx.window_s * roofline.PEAK_BF16_FLOPS)

"""flash_roofline.score: the least time of the profiled scoring calls'
flash attention (one causal call a layer over (batch, seq, heads,
head_dim) in bf16, ``roofline.flash_call``), over the device time of the
kernels of ``flash_attention.cu`` in the profile, in %."""
from portbench import roofline


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.steps or "flash_attention" not in prof.by_source:
        return None
    c = ctx.conf
    p = ctx.mix
    per = roofline.bound_s(*roofline.flash_call(
        int(p["batch"]), int(p["seq"]), int(c["num_attention_heads"]),
        int(c["head_dim"])))
    calls = len(prof.steps) * int(c["num_hidden_layers"])
    return 100.0 * per * calls / prof.by_source["flash_attention"][0]

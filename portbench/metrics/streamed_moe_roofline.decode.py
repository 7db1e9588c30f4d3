"""streamed_moe_roofline.decode: the least time of the profiled steps'
``streamed_moe`` calls, each counted by what its routed rows need
(``roofline.streamed_moe_call``: the experts that got a row, the rows'
activations, 6 d m operations a row), over the device time of the
kernels of ``streamed_moe.cu`` in the profile, in %."""
from portbench import roofline


def read(ctx):
    prof = ctx.profile
    if prof is None or "streamed_moe" not in prof.by_source:
        return None
    counts = [c for s in prof.steps for _, _, c in s.records]
    if not counts:
        return None
    d, m = int(ctx.conf["hidden_size"]), int(ctx.conf["moe_intermediate_size"])
    bound = roofline.streamed_moe_bound_s(d, m, counts)
    return 100.0 * bound / prof.by_source["streamed_moe"][0]

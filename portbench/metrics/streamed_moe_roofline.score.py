"""streamed_moe_roofline.score: the least time of the profiled scoring
calls' ``streamed_moe`` launches (one a layer; all E experts get rows;
T k routed rows, at most C an expert), over the device time of the
kernels of ``streamed_moe.cu`` in the profile, in %.  The rows are
counted as spread evenly over the experts: the operations and the
activations' bytes depend only on their sum, which is T k unless the
capacity drops a choice."""
import numpy as np

from portbench import roofline


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.steps or "streamed_moe" not in prof.by_source:
        return None
    c = ctx.conf
    p = ctx.mix
    T = int(p["batch"]) * int(p["seq"])
    E, k = int(c["n_routed_experts"]), int(c["num_experts_per_tok"])
    counts = np.full((E,), T * k // E)
    C = max(1, -(-int(T * k * float(c["capacity_factor"])) // E))
    launches = len(prof.steps) * int(c["num_hidden_layers"])
    bound = roofline.streamed_moe_bound_s(
        int(c["hidden_size"]), int(c["moe_intermediate_size"]),
        [counts] * launches, capacity=C)
    return 100.0 * bound / prof.by_source["streamed_moe"][0]

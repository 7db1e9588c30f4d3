"""library_device_ms.score: device milliseconds a scoring call spends in
kernels that are not the port's own (library ops: the one-hot dispatch
and combine products, projections, norms, the loss), from the profiled
calls."""


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.steps or "library" not in prof.by_source:
        return None
    return 1e3 * prof.by_source["library"][0] / len(prof.steps)

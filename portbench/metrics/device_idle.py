"""The device's idle share of the profiled segment (the window span, from
its open to the device's idle), in %: 100 x (1 - busy / window), busy
the union of every device record's interval."""


def read(ctx):
    if ctx.profile is None:
        return None
    return 100.0 * ctx.profile.idle_share

"""score_tok_s: tokens scored in the window (batch x seq of every call in
it), over the window's seconds."""


def read(ctx):
    if not ctx.calls:
        return None
    p = ctx.mix
    return len(ctx.calls) * int(p["batch"]) * int(p["seq"]) / ctx.window_s

"""decode_tok_s: output tokens the engine emitted in the window's steps
(its ``tokens_emitted`` counter), over the window's seconds."""
from portbench.readers import window_steps


def read(ctx):
    steps = window_steps(ctx)
    if not steps:
        return None
    return sum(s.stats["tokens_emitted"] for s in steps) / ctx.window_s

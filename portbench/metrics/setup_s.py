"""setup_s: seconds from the process's start (the harness's first line) to
the window's opening: imports, CUDA initialisation, the kernels' build or
load, the weights' draw, engine and graph set-up, warm-up."""


def read(ctx):
    return ctx.window[0] - ctx.t_start

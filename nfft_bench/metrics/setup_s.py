"""setup_s: the harness's start to the end of warm-up (host clock):
loading the port and its kernels, the inputs, the plan or operator, and
the warm-up calls."""


def read(ctx):
    return ctx.setup_s

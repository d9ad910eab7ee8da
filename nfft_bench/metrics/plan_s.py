"""plan_s (layer: plan, ``ops/binned.py``'s ``build_plan_device``, or the
host ``build_plan`` through ``GaussianKernel``): host clock to a
synchronised plan or operator in set-up."""


def read(ctx):
    return ctx.plan_s

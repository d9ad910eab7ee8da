"""plan_build_s (layer: plan, ``ops/binned.py``'s ``build_plan`` and
``build_plan_device``): host seconds of the outermost plan-builder spans
of set-up (``nfftb/spans.py``); None without the program's spans."""

from nfftb import spans


def read(ctx):
    att = spans.program_of(ctx)
    return None if att is None else spans.plan_build_s(att)

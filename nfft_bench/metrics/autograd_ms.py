"""autograd_ms (layer: autograd, ``ops/binned.py``'s ``_Spread`` and
``_Gather`` backward): device ms per step of the operations launched
inside the program's ``backward`` spans (``nfftb/spans.py``); None
without the program's spans or where no backward ran."""

from nfftb import spans

STAGES = ("backward",)


def read(ctx):
    att = spans.program_of(ctx)
    return None if att is None else att.device_ms_within(STAGES)

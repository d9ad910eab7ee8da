"""backward_ms (layer: autograd, ``ops/binned.py``'s ``_Spread`` and
``_Gather`` backward): CUDA events around ``loss.backward()``, summed
over the window's steps over the steps."""


def read(ctx):
    ms = ctx.spans.get("backward_ms")
    return sum(ms) / len(ms) if ms else None

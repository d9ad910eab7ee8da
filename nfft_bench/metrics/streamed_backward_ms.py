"""streamed_backward_ms (layer: streamed backward, ``ops/streaming.py``'s
``_PairStreamed`` backward, member by member): CUDA events around
``loss.backward()`` (the system's span ``backward_ms``), summed over the
window's steps over the steps."""


def read(ctx):
    ms = ctx.spans.get("backward_ms")
    return sum(ms) / len(ms) if ms else None

"""host_overhead_ms (layer: host, the port's Python between its
launches): device idle ms per call in the gaps whose midpoint lies
inside one of the program's spans (``nfftb/spans.py``); None without
the program's spans or device activity."""

from nfftb import spans


def read(ctx):
    att = spans.program_of(ctx)
    if att is None or att.calls <= 0 or att.device_ns <= 0 or not att.window:
        return None
    return att.idle_in_spans_ns / 1e6 / att.calls

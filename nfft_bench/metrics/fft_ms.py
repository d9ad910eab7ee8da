"""fft_ms (layer: spectral, ``ops/fft.py`` on cuFFT): device ms per call
of the kernels whose names match the pattern here (cuFFT's)."""

from nfftb import trace

PATTERN = r"(?i)fft"


def read(ctx):
    if ctx.trace is None or ctx.win.calls == 0:
        return None
    ns = trace.total_ns(ctx.trace, PATTERN)
    return ns / 1e6 / ctx.win.calls if ns > 0 else None

"""call_ms_p95: the 95th percentile of every call of the window, each
from issue to ``torch.cuda.synchronize()`` (host clock)."""

from nfftb import window


def read(ctx):
    return window.percentile_ms(ctx.win.times_s, 95)

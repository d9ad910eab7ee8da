"""device_idle_pct (layer: device): 100 - the union of the device's
activity (kernels, copies, fills) in the traced window over the
window's length (host clock), in percent."""

from nfftb import trace


def read(ctx):
    if ctx.trace is None:
        return None
    busy = trace.busy_ns(ctx.trace)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / 1e9 / ctx.win.window_s)

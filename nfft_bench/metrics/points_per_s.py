"""points_per_s: n * C points of every completed call over the window's
seconds (host clock), one rate over the whole window."""

from nfftb import window


def read(ctx):
    return window.rate(ctx.win.calls, ctx.points_per_call, ctx.win.window_s)

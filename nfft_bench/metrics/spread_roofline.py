"""spread_roofline (layer: spread kernels, ``csrc/contract.cu``, B1 and
B7): the least time of the window's spreads, counted from the cell's
shapes and points (``nfftb/roofline.py``), over the device time of the
kernels named here, in percent."""

KERNELS = ("spread_kernel", "spread_contract_kernel")
PATTERN = r"\b(" + "|".join(KERNELS) + r")\b"


def read(ctx):
    return ctx.roofline_pct(("spread",), PATTERN)

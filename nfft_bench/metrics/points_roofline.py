"""points_roofline (layer: gather and pos_grad kernels,
``csrc/points.cuh``, B2 and B5): the least time of the window's gathers
and position gradients, counted from the cell's shapes and points
(``nfftb/roofline.py``), over the device time of the kernels named here,
in percent."""

KERNELS = ("points_kernel",)
PATTERN = r"\b(" + "|".join(KERNELS) + r")\b"


def read(ctx):
    return ctx.roofline_pct(("gather", "pos_grad"), PATTERN)

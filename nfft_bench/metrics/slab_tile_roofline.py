"""slab_tile_roofline (layer: slab tile movement, ``csrc/tilefold.cu``'s
slab fold and unfold through ``parallel/grid_sharded.py``): the least time
of rank 0's slab folds and unfolds in the window over the device time of
the kernels named here, in percent.

Each reads one array once and writes the other once, float32 at 3.35 TB/s
(``nfftb/roofline.py``): the slab's dense tiles, (L0/T) (M/T)^(dim-1)
tiles of H^dim cells a column, and its grid rows with the E = H - T rows
past them, (L0 + E) M^(dim-1) cells a column; L0 = M / shards,
H = T + 2m + 1. A pair folds once and unfolds once."""

from nfftb import roofline, trace

KERNELS = ("slab_fold_kernel", "slab_unfold_kernel")
PATTERN = r"\b(" + "|".join(KERNELS) + r")\b"
MOVES_PER_CALL = {"pair": 2}


def slab_bytes(config: dict, columns: int) -> int:
    """Bytes of one slab fold (or unfold) of ``columns`` columns."""
    dim, T, m = int(config["dim"]), int(config["tile"]), int(config["cutoff"])
    M = round(float(config["oversampling"]) * int(config["bandwidth"]))
    L0, H = M // int(config["shards"]), T + 2 * m + 1
    tiles = (L0 // T) * (M // T) ** (dim - 1) * H**dim
    rows = (L0 + H - T) * M ** (dim - 1)
    return roofline.F32 * columns * (tiles + rows)


def read(ctx):
    moves = MOVES_PER_CALL.get(ctx.cell.traffic["call"], 0)
    if ctx.trace is None or ctx.win.calls == 0 or moves == 0:
        return None
    device_s = trace.total_ns(ctx.trace, PATTERN) / 1e9
    if device_s <= 0:
        return None
    least_s = moves * slab_bytes(ctx.config, ctx.columns) / roofline.PEAK_BYTES_PER_S
    return 100.0 * least_s * ctx.win.calls / device_s

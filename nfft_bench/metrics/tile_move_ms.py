"""tile_move_ms (layer: tile movement, ``ops/tilefold.py``'s fold and
unfold and ``ops/binned.py``'s ``tiles_to_grid`` / ``grid_to_tiles``):
device ms per call of the operations launched inside the program's
stage spans named here (``nfftb/spans.py``); None without the program's
spans."""

from nfftb import spans

STAGES = ("fold", "unfold", "tiles to grid", "grid to tiles")


def read(ctx):
    att = spans.program_of(ctx)
    return None if att is None else att.device_ms_within(STAGES)

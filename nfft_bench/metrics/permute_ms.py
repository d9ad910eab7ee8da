"""permute_ms (layer: permutations, ``ops/binned.py``'s ``slot_values``
and ``unslot_values``, on the Benes route B3 and B4): device ms per call
of the operations launched inside the program's stage spans named here
(``nfftb/spans.py``); None without the program's spans."""

from nfftb import spans

STAGES = ("slot_values", "unslot_values")


def read(ctx):
    att = spans.program_of(ctx)
    return None if att is None else att.device_ms_within(STAGES)

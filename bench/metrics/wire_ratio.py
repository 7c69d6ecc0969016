"""Bytes of the Recoil containers the program's own packer emits, thinned
to the cell's client thread counts, over the raw bytes those clients
receive (the paper's transfer cost).  Fixed by the seed."""

LAYER = "end to end"
UNIT = "%"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.wire_ratio_pct

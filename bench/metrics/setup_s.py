"""Set-up: imports, content made on the card, ingest, packing and
registration, the cell's plans and launches warmed (and, in a checkout's
first run, the kernels built)."""

LAYER = "end to end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s

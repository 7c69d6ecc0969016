"""Peak device memory allocated in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""

LAYER = "device: H100"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "decode_GBps"


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None

"""How many walks run at once on the device: the walk kernels' summed time
in the profiler's trace over the device's busy time.  About 1 when the
walks run one after another; up to the engine's stream pool when they run
side by side."""

KERNELS = ("walk_pointer_kernel", "walk_symbol_kernel")

LAYER = "engine: core/engine"
UNIT = "x"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_GBps"


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return run.trace.seconds_matching(*KERNELS) / run.trace.busy_s

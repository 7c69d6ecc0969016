"""Least time of the window's decodes by ``bench/roofline.py``'s byte
count, over the walk kernels' time in the profiler's trace."""

from bench import roofline

KERNELS = ("walk_pointer_kernel", "walk_symbol_kernel")

LAYER = "kernels: kernels/rans_decode"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_GBps"


def read(run):
    if run.trace is None:
        return None
    b = sum(run.walk_bytes[(r.asset, r.threads)] for r in run.reqs
            if r.status == "ok")
    return roofline.share_pct(b, run.trace.seconds_matching(*KERNELS))

"""Host time of a ``DecodeService.decode`` call, from the call to its
return (the benchmark's own span), mean over the window's requests."""

LAYER = "service: runtime/serve.py"
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "decode_GBps"


def read(run):
    t = [r.enqueue_s for r in run.reqs]
    return 1e6 * sum(t) / len(t) if t else None

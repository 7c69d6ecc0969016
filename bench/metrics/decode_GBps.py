"""Raw bytes of all the content decoded and ready on the device in the
window, over the window's length.  The closed loop's clients issue for
``--seconds``; the window closes when the last request issued is ready."""

LAYER = "end to end"
UNIT = "GB/s"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = None


def read(run):
    done = [r for r in run.reqs if r.status == "ok"]
    if not done:
        return None
    return sum(run.raw_bytes[r.asset] for r in done) / max(
        r.done for r in done) / 1e9

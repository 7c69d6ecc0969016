"""The program's own ``recoil.*`` ranges in a traced window: the host time
of a ``decode`` split by layer, and the device's idle time put down to the
program's code, the collector or the profiler.

The port opens ``recoil.decode`` > ``recoil.execute`` >
``recoil.walk.launch`` > ``recoil.walk.alloc`` on the calling thread and
``recoil.gc`` around each collector pause, as ``torch.profiler`` ranges
(``repro_torch.spans``).  ``reduce`` works on interval tuples; ``from_trace``
feeds it from the same ``prof.events()`` and with the same device
operations and traced window as ``tracing.summarize``.

The profiler's own host events (CUPTI's buffer requests and flushes) fall
inside the program's ranges and between them.  Idle time under them is the
profiler's, not the program's: a gap there is labelled ``profiler`` and left out of the
program's idle share.  The host metrics are taken under the profiler all
the same, and read above an untraced call by what it records inside them.

Run a cell traced and print its result line with the reduction added
(``program``, and ``breakdown.idle_gaps_program``):

    python3 bench/program_spans.py --workload <cell> --seed <n> [--seconds 10]

The run is ``run.py``'s own, with ``--trace 1``; only the reduction of the
trace is added.  It exits non-zero without a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

PREFIX = "recoil."
CALL = "recoil.decode"
GC = "recoil.gc"
NO_SPAN = "no program span"
PROFILER = "profiler"
# The profiler's own host events (CUPTI overhead records), by name.
PROFILER_EVENTS = frozenset({"Activity Buffer Request", "Buffer Flush"})

# metric -> (span, "self" or "total"): host time a call, mean per CALL.
HOST_METRICS = {
    "service_self_us.decode": (CALL, "self_us"),
    "engine_self_us.decode": ("recoil.execute", "self_us"),
    "launch_self_us.decode": ("recoil.walk.launch", "self_us"),
    "alloc_us.decode": ("recoil.walk.alloc", "total_us"),
}


def _union(intervals) -> list:
    """Sorted disjoint (a, b) covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _intersect(xs, ys) -> list:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _idle(dev, lo: float, hi: float) -> list:
    """The gaps between device operations in ``[lo, hi]``."""
    gaps, at = [], lo
    for a, b in _union(dev):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _self_times(ranges) -> list:
    """Each range's time less the union of its direct children: the
    ranges it holds on its own thread with no range between."""
    children = [[] for _ in ranges]
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][3], ranges[i][0], -ranges[i][1]))
    stack = []
    for i in order:
        a, b, _, thread = ranges[i]
        while stack and (ranges[stack[-1]][3] != thread
                         or ranges[stack[-1]][1] <= a
                         or ranges[stack[-1]][1] < b):
            stack.pop()
        if stack:
            children[stack[-1]].append((a, b))
        stack.append(i)
    return [(b - a) - _length(_union(children[i]))
            for i, (a, b, _, _) in enumerate(ranges)]


def _label(gap, ranges, profiler) -> str:
    """``profiler`` if one of its events is open at the gap's middle, else
    the innermost range open there, on any thread."""
    mid = (gap[0] + gap[1]) / 2
    if any(a <= mid <= b for a, b in profiler):
        return PROFILER
    open_ = [r for r in ranges if r[0] <= mid <= r[1]]
    if not open_:
        return NO_SPAN
    return max(open_, key=lambda r: (r[0], r[0] - r[1]))[2]


def reduce(dev, lo: float, hi: float, ranges, profiler=()) -> dict | None:
    """The program's spans over a traced window, times in µs as the
    profiler gives them.

    ``dev``: (start, end) of each device operation; ``[lo, hi]``: the
    traced window; ``ranges``: (start, end, name, thread) of each host
    ``recoil.*`` range; ``profiler``: (start, end) of each of the
    profiler's own host events.  None without device operations or
    without a ``recoil.decode`` range."""
    if not dev or not any(r[2] == CALL for r in ranges):
        return None
    selfs = _self_times(ranges)
    spans: dict = {}
    for (a, b, name, _), s in zip(ranges, selfs):
        e = spans.setdefault(name, {"count": 0, "total_us": 0.0,
                                    "self_us": 0.0})
        e["count"] += 1
        e["total_us"] += b - a
        e["self_us"] += s
    gaps = _idle(dev, lo, hi)
    in_gc = _intersect(gaps, _union((a, b) for a, b, n, _ in ranges
                                    if n == GC))
    in_code = _intersect(gaps, _union((a, b) for a, b, n, _ in ranges
                                      if n != GC))
    in_prof = _intersect(gaps, _union(profiler))
    # Under the collector or the profiler is not the program's own idle.
    not_code = _union(in_gc + in_prof)
    idle = _length(gaps)
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return {
        "spans": spans,
        "idle_s": idle * 1e-6,
        "idle_in_gc_s": _length(in_gc) * 1e-6,
        "idle_in_profiler_s": _length(in_prof) * 1e-6,
        "idle_in_program_s": (_length(in_code) - _length(
            _intersect(in_code, not_code))) * 1e-6,
        "idle_gaps_program": [[_label(g, ranges, profiler),
                               (g[1] - g[0]) * 1e-6] for g in longest],
    }


def metrics(red: dict | None) -> dict:
    """The six per-layer numbers of a reduction (none without one; a share
    is left out when the window had no idle time)."""
    if red is None:
        return {}
    calls = red["spans"][CALL]["count"]
    out = {m: red["spans"].get(name, {}).get(field, 0.0) / calls
           for m, (name, field) in HOST_METRICS.items()}
    if red["idle_s"] > 0:
        out["idle_in_program_pct.decode"] = \
            100.0 * red["idle_in_program_s"] / red["idle_s"]
        out["idle_in_gc_pct.decode"] = \
            100.0 * red["idle_in_gc_s"] / red["idle_s"]
    return out


def from_trace(prof) -> dict | None:
    """``reduce`` over a profiler's events.  Device operations and the
    window are ``tracing.summarize``'s: device events that are neither a
    ``bench.`` name nor a user annotation (a ``bench.`` span's shadow on
    the device's timeline), the window from the first of them or of the
    host ``bench.`` spans to the last."""
    dev, bench_spans, ranges, profiler = [], [], [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        on_card = str(ev.device_type).endswith("CUDA")
        if not on_card and ev.name.startswith(PREFIX):
            ranges.append((a, b, ev.name, ev.thread))
        if ev.name in PROFILER_EVENTS:
            profiler.append((a, b))
        if ev.name.startswith("bench.") or getattr(
                ev, "is_user_annotation", False):
            if not on_card and ev.name.startswith("bench."):
                bench_spans.append((a, b))
        elif on_card:
            dev.append((a, b))
    if not dev:
        return None
    lo = min([a for a, _ in dev] + [a for a, _ in bench_spans])
    hi = max([b for _, b in dev] + [b for _, b in bench_spans])
    return reduce(dev, lo, hi, ranges, profiler)


def main(argv=None) -> int:
    import torch

    from bench import run, tracing
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this tool reads the card's trace",
              file=sys.stderr)
        return 2
    held = {}

    def summarize(prof):
        held["program"] = from_trace(prof)
        return tracing.summarize(prof)

    run.summarize = summarize        # the same events feed both
    res = run.run_cell(args.workload, args.seed, args.seconds, trace=True)
    red = held.get("program")
    res["program"] = None if red is None else {
        "metrics": metrics(red),
        **{k: v for k, v in red.items() if k != "idle_gaps_program"}}
    if red is not None and "breakdown" in res:
        res["breakdown"]["idle_gaps_program"] = red["idle_gaps_program"]
    print(json.dumps(res), flush=True)
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())

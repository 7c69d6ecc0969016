"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: device time by operation, the device's busy time
over the traced window, and the idle gaps labelled
by the benchmark's own host span around them.

The benchmark's host spans are ``torch.profiler.record_function`` ranges
named ``bench.<what>`` (``span`` below), taken from its own files around
its calls into the program.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch


def span(name: str, traced: bool):
    """A ``bench.<name>`` range in the trace, or nothing when untraced."""
    if not traced:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"bench.{name}")


@dataclasses.dataclass
class Summary:
    window_s: float                       # traced span, first to last event
    busy_s: float                         # union of device operations
    device_s: dict                        # operation name -> seconds
    top_ops: list                         # [[name, seconds]] x <= 10
    idle_gaps: list                       # [[host span, seconds]] x <= 10

    def seconds_matching(self, *parts: str) -> float:
        return sum(s for n, s in self.device_s.items()
                   if any(p in n for p in parts))


def _is_device(ev) -> bool:
    return str(ev.device_type).endswith("CUDA")


def summarize(prof) -> Summary | None:
    """Summary of the device events of ``prof`` (None if it holds none).
    The traced window runs from its first event to its last, the
    benchmark's ``bench.window`` span included."""
    dev, host = [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("bench.") or getattr(
                ev, "is_user_annotation", False):
            # A span on the device's timeline is the host span's shadow,
            # not an operation.
            if not _is_device(ev) and ev.name.startswith("bench."):
                host.append((a, b, ev.name))
        elif _is_device(ev):
            dev.append((a, b, ev.name))
    if not dev:
        return None
    dev.sort()
    lo = min([dev[0][0]] + [a for a, _, _ in host])
    hi = max([b for _, b, _ in dev] + [b for _, b, _ in host])
    by_name: dict = {}
    busy = 0.0
    gaps = []
    cur_a, cur_b = None, None
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if cur_b is None:
            if a > lo:
                gaps.append((lo, a))
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if hi > cur_b:
        gaps.append((cur_b, hi))
    host.sort()
    starts = [a for a, _, _ in host]

    def label(mid: float) -> str:
        # The innermost bench span open at the gap's middle.
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            a, b, name = host[j]
            if b >= mid:
                return name
        return "no bench span"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return Summary(
        window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, device_s=by_name,
        top_ops=[[n, s] for n, s in top],
        idle_gaps=[[label((a + b) / 2), (b - a) * 1e-6]
                   for a, b in gaps[:10]])

"""Ranges on the profiler's clock, free while no profiler records.

``span(name)`` puts ``name`` on a ``torch.profiler`` trace as a host
range.  The profiler's clock is the one the device trace shares, so a
reader can lay the program's own ranges over the device's idle gaps.
While no profiler records, ``span`` returns one shared no-op context after
a single flag read: a range costs microseconds even with no profiler, and
the decode path opens four a call.

A range is torch's ``_RecordFunctionFast``: one C++ object, which leaves
no shadow on the device's timeline.

``install_gc_span()`` adds a ``gc.callbacks`` hook that puts each
collector pause, from its ``start`` to its ``stop``, on the trace as a
``recoil.gc`` range, opened only while a profiler records.  It installs
once per process; while no profiler records, the hook's body is one read.

The ranges the port opens, outermost first on the calling thread:

  * ``recoil.decode``: ``DecodeService.decode``, the whole call;
  * ``recoil.execute``: ``DecoderSession.execute``, the lock, launcher
    cache, stats and profiler record, then the executor's run;
  * ``recoil.walk.launch``: ``Executor.run``, the kernel wrapper (its
    checks, allocations and launch; on the CPU the plain walk);
  * ``recoil.walk.alloc``: the CUDA wrappers' output and ``qf``
    allocations;
  * ``recoil.gc``: a collector pause, on whichever thread it ran.

Depends on torch only, so ``core`` and ``kernels`` import it without
importing ``runtime``.
"""

from __future__ import annotations

import contextlib
import gc

import torch
from torch.autograd import profiler as _autograd_profiler

NULL_SPAN = contextlib.nullcontext()
GC_SPAN = "recoil.gc"
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A range named ``name`` while a profiler records, else
    :data:`NULL_SPAN` (the flag the profiler sets on start and clears on
    stop, read once)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL_SPAN
    return _RANGE(name)


class _GcSpan:
    """The collector's pauses as ``recoil.gc`` ranges.  A collection runs
    start to stop on one thread and never nests, so one slot holds the
    open range."""

    def __init__(self):
        self.open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _autograd_profiler._is_profiler_enabled:
                self.open = _RANGE(GC_SPAN)
                self.open.__enter__()
        elif self.open is not None:
            rf, self.open = self.open, None
            rf.__exit__(None, None, None)


_GC_HOOK = _GcSpan()


def install_gc_span() -> None:
    """Add the collector hook to ``gc.callbacks``, once per process."""
    if _GC_HOOK not in gc.callbacks:
        gc.callbacks.append(_GC_HOOK)

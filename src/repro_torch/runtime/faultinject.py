"""Fault injection for the serving stack (DESIGN.md §14).

The reliability suite needs to *drive* every unhappy path the serving tier
can hit — a dispatch that raises mid-group, a poisoned container, an
encode executable that stalls — deterministically and without monkey
-patching engine internals.  This module is that lever: named **fault
points** threaded through the serving runtime (``DecodeService`` dispatch /
ingest / executor boundaries and the broker's worker loops) consult an
injector that is a no-op in production and armable per site in tests and
benchmarks.

Fault sites currently wired (grep for ``faults.fire`` / ``faults.corrupt``):

  ====================================  =====================================
  site                                  boundary
  ====================================  =====================================
  ``service.ingest``                    DecodeService.ingest entry
  ``service.extend``                    DecodeService.extend entry
  ``service.register``                  corrupt point: the stream handed to
                                        register (validation must catch it)
  ``service.dispatch_group``            group build, before the service lock
  ``service.execute``                   executor boundary, right before the
                                        fused executable runs
  ``service.dispatch_stream``           chunked stream dispatch
  ``broker.quantize``                   broker fused path, before group
                                        quantization (the historical
                                        pre-``try`` crash site)
  ``broker.decode_worker``              decode worker loop, OUTSIDE the
                                        dispatch error handling — only the
                                        supervisor can catch it
  ``broker.ingest_worker``              ingest worker loop, ditto
  ====================================  =====================================

Modes:

  * ``raise`` — raise ``exc`` (:class:`FaultInjected` by default) the first
    ``times`` firings (``times=None`` -> always).  ``times=1`` is the
    transient "raise-once" fault the retry path exists for; ``times=None``
    the persistent fault quarantine exists for.
  * ``delay`` — sleep ``delay_s`` before continuing (slow-shard emulation;
    proves timeouts/deadlines rather than errors).
  * ``corrupt`` — only consulted by :meth:`FaultInjector.corrupt` sites:
    the armed ``mutate`` callable transforms the value flowing through
    (e.g. :func:`drop_last_word` truncates a stream so registration
    validation rejects it loudly).

``match`` narrows a spec to specific firings (a predicate over the call
site's context kwargs), e.g. ``match=lambda ctx: "bad" in ctx["names"]``
poisons one content's dispatches only.

Everything is thread-safe: worker threads fire concurrently with a test
arming/disarming.  The production configuration is :data:`NULL_INJECTOR`
(a shared singleton whose ``fire`` is an empty method), so the hot-path
cost of an unarmed stack is one attribute load + no-op call per *dispatch*
(not per request) — priced by ``bench_reliability``'s >= 0.97x guard.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


class FaultInjected(RuntimeError):
    """Default exception raised by an armed ``raise`` fault point."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: see the module docstring for mode semantics."""

    site: str
    mode: str = "raise"                      # raise | delay | corrupt
    times: Optional[int] = 1                 # remaining firings; None=always
    exc: object = None                       # instance or class; None -> FaultInjected
    delay_s: float = 0.0
    mutate: Optional[Callable] = None        # corrupt mode: value -> value
    match: Optional[Callable] = None         # ctx predicate; None -> all
    fired: int = 0                           # firings that took effect


class FaultInjector:
    """Armable fault points for the serving stack (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self.fires: dict[str, int] = {}      # site -> effective firings

    # ------------------------------------------------------------------
    # Arming
    # ------------------------------------------------------------------

    def arm(self, site: str, mode: str = "raise", *, times: Optional[int] = 1,
            exc=None, delay_s: float = 0.0, mutate: Optional[Callable] = None,
            match: Optional[Callable] = None) -> FaultSpec:
        """Arm one fault at ``site`` (replacing any previous spec there)."""
        if mode not in ("raise", "delay", "corrupt"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if mode == "corrupt" and mutate is None:
            raise ValueError("corrupt mode requires a mutate callable")
        spec = FaultSpec(site=site, mode=mode, times=times, exc=exc,
                         delay_s=float(delay_s), mutate=mutate, match=match)
        with self._lock:
            self._specs[site] = spec
        return spec

    def disarm(self, site: Optional[str] = None) -> None:
        """Disarm one site (or every site when ``site`` is None)."""
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    @property
    def armed(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._specs))

    # ------------------------------------------------------------------
    # Fault points
    # ------------------------------------------------------------------

    def _take(self, site: str, ctx: dict) -> Optional[FaultSpec]:
        """Claim one firing of the spec armed at ``site`` (None if the
        site is unarmed, exhausted, or the context doesn't match)."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None or spec.mode == "corrupt":
                return None
            if spec.match is not None and not spec.match(ctx):
                return None
            if spec.times is not None:
                if spec.times <= 0:
                    return None
                spec.times -= 1
            spec.fired += 1
            self.fires[site] = self.fires.get(site, 0) + 1
            return spec

    def fire(self, site: str, **ctx) -> None:
        """Execute the fault armed at ``site`` (no-op when unarmed).
        ``raise`` specs raise; ``delay`` specs sleep OUTSIDE the injector
        lock (a slow shard must not serialize other fault points)."""
        spec = self._take(site, ctx)
        if spec is None:
            return
        if spec.mode == "delay":
            time.sleep(spec.delay_s)
            return
        exc = spec.exc
        if exc is None:
            exc = FaultInjected(f"injected fault at {site} (ctx={ctx})")
        elif isinstance(exc, type):
            exc = exc(f"injected fault at {site} (ctx={ctx})")
        raise exc

    def corrupt(self, site: str, value, **ctx):
        """Pass ``value`` through the corrupt spec armed at ``site``
        (identity when unarmed).  The mutate callable runs outside the
        injector lock."""
        with self._lock:
            spec = self._specs.get(site)
            if spec is None or spec.mode != "corrupt":
                return value
            if spec.match is not None and not spec.match(ctx):
                return value
            if spec.times is not None:
                if spec.times <= 0:
                    return value
                spec.times -= 1
            spec.fired += 1
            self.fires[site] = self.fires.get(site, 0) + 1
            mutate = spec.mutate
        return mutate(value)

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": sorted(self._specs),
                    "fired": dict(self.fires)}


class NullInjector:
    """The production injector: every fault point is a no-op.  Shared
    singleton (:data:`NULL_INJECTOR`) — do not arm it; construct a
    :class:`FaultInjector` and pass it to the service instead."""

    armed = ()

    def fire(self, site: str, **ctx) -> None:
        return None

    def corrupt(self, site: str, value, **ctx):
        return value

    def snapshot(self) -> dict:
        return {"armed": [], "fired": {}}


NULL_INJECTOR = NullInjector()


def drop_last_word(stream):
    """Canonical container corruption for ``service.register``: truncate
    one stream word, so the plan/stream word-count agreement check in
    registration validation rejects the payload loudly (a silently
    mis-decoding corruption is exactly what validation exists to prevent,
    so the injected one must be *detectable by construction*)."""
    import numpy as np

    from ..core.engine import DeviceStream
    if isinstance(stream, DeviceStream):
        # The resident words are int16 bit patterns padded to the bucket:
        # take the original words where the handle kept them, else the
        # first n_words - 1 device words as u16, in one copy.
        if stream.host is not None:
            return np.asarray(stream.host)[: stream.n_words - 1]
        return stream.words[: stream.n_words - 1].cpu().numpy().view(
            np.uint16)
    return np.asarray(stream)[:-1]

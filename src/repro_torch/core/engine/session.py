"""DecoderSession: a thin plan -> launcher cache over a pluggable executor.

The session owns exactly three things:

  * device-resident slot tables, uploaded once at construction;
  * the plan cache — ``plan.key -> launcher`` — so ``stats.compiles``
    counts the distinct bucketed shapes this session has resolved exactly;
  * request accounting (:class:`EngineStats`).

All backend knowledge lives in the executor (``cuda`` / ``torch`` — see
``engine.executors``).  The prepare/execute split is public API: callers
that re-issue the same request shape (e.g. ``runtime.serve.DecodeService``)
cache the :class:`DecodePlan` and skip the host-side preparation entirely.

Thread model: the cache and stats are guarded by ``_lock`` — a cache miss
resolves under the lock (a racing thread waits instead of resolving twice,
keeping ``stats.compiles`` exact), while the launch itself runs outside it.
Executor ``plan()`` needs no *session* lock; its only shared state is the
layout counter, guarded by its own lock.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ...device import resolve_device
from ..rans import StaticModel
from ..vectorized import WalkBatch
from .executors import make_executor
from .plan import LEGACY_POLICY, BucketPolicy, DecodePlan, DeviceStream


@dataclasses.dataclass
class EngineStats:
    compiles: int = 0      # launchers resolved (plan-key misses)
    cache_hits: int = 0    # decodes served by an already-resolved key
    decodes: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class DecoderSession:
    """Device-resident Recoil decoder with a bucketed plan cache.

    ``device`` defaults to ``"cuda"``; with no card present that raises —
    pass ``device="cpu"`` for the plain torch walks.  ``impl=None`` picks
    ``"cuda"`` (the Hopper kernels) on a CUDA device and ``"torch"`` on the
    CPU; each impl runs only on its own device type, so the plain walk never
    serves a session on the card.  ``packed_lut`` defaults to auto: the §4.4
    packed table whenever the model fits it.

    ``layout`` is the stream-layout policy: ``"auto"`` (default) runs the
    pointer-free symbol-indexed walk for handles that carry a
    ``words_by_symbol`` permutation and the classic pointer walk otherwise;
    ``"pointer"``/``"symbol"`` force one layout.  ``policy`` is the bucket
    ladder: ``None`` for the legacy pow2/midpoint ladder, or a
    :class:`BucketPolicy`.
    """

    def __init__(self, model: StaticModel, *, device="cuda", impl=None,
                 packed_lut: bool | None = None, layout: str = "auto",
                 policy=None):
        from ...kernels.rans_decode.ops import _luts, packed_lut_ok
        self.device = resolve_device(device)
        if impl is None:
            impl = "cuda" if self.device.type == "cuda" else "torch"
        self.model = model
        self.impl = impl
        if packed_lut is None:
            packed_lut = packed_lut_ok(model)
        elif packed_lut and not packed_lut_ok(model):
            raise ValueError("packed LUT requires 8-bit symbols and n <= 12")
        self.packed_lut = packed_lut
        if policy is None:
            policy = LEGACY_POLICY
        elif not isinstance(policy, BucketPolicy):
            raise ValueError(f"policy must be None or a BucketPolicy, got "
                             f"{policy!r}")
        self.policy = policy
        # Device-resident slot tables, uploaded once.
        self._luts = _luts(model, packed_lut, self.device)
        self.executor = make_executor(impl, model, packed_lut, self._luts,
                                      self.device, layout=layout,
                                      policy=self.policy)
        self._exec: dict[tuple, object] = {}
        self._lock = threading.Lock()   # guards _exec + stats (see header)
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    # Streams
    # ------------------------------------------------------------------

    def upload_stream(self, stream: np.ndarray) -> DeviceStream:
        """Register a bitstream once; reuse the handle across decodes."""
        return self.executor.upload_stream(stream)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def decode(self, plan, stream, final_states) -> torch.Tensor:
        """RecoilPlan + stream (+ transmitted final states) -> device int32
        symbol tensor.  ``stream`` may be a raw word array or a resident
        :class:`DeviceStream` from :meth:`upload_stream`."""
        from ..recoil import build_split_states
        splits = build_split_states(plan, final_states)
        batch = WalkBatch.from_splits(splits, plan.ways)
        return self.decode_batch(batch, stream, plan.n_symbols)

    def decode_conventional(self, conv) -> torch.Tensor:
        """Conventional-partitioning adapter through the same engine."""
        from ..conventional import to_split_states
        splits, words, out_bases = to_split_states(conv)
        batch = WalkBatch.from_splits(splits, self.model.params.ways,
                                      out_bases)
        return self.decode_batch(batch, words, conv.n_symbols)

    def prepare(self, batch: WalkBatch, stream, n_symbols: int) -> DecodePlan:
        """Host-side request preparation only (no dispatch): bucket, pad,
        assemble args.  The returned plan may be cached and re-executed."""
        if n_symbols >= 2 ** 31:
            raise ValueError(
                f"n_symbols={n_symbols} exceeds int32 device-scatter indices")
        if not isinstance(stream, DeviceStream):
            stream = self.upload_stream(stream)
        return self.executor.plan(batch, stream, n_symbols)

    def is_compiled(self, plan: DecodePlan) -> bool:
        """Whether :meth:`execute` would reuse an already-resolved launcher
        for this plan's key."""
        with self._lock:
            return plan.key in self._exec

    @property
    def executables(self) -> int:
        """Number of distinct plan keys resolved so far."""
        with self._lock:
            return len(self._exec)

    def execute(self, plan: DecodePlan) -> torch.Tensor:
        """Run a prepared plan: resolve its launcher on a key miss, else
        reuse it; the launch runs outside the lock."""
        with self._lock:
            self.stats.decodes += 1
            fn = self._exec.get(plan.key)
            if fn is None:
                fn = self.executor.lower(plan)
                self._exec[plan.key] = fn
                self.stats.compiles += 1
            else:
                self.stats.cache_hits += 1
        return self.executor.run(fn, plan)[:plan.n_symbols]

    def decode_batch(self, batch: WalkBatch, stream,
                     n_symbols: int) -> torch.Tensor:
        return self.execute(self.prepare(batch, stream, n_symbols))

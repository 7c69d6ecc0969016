"""DecoderSession: a thin plan -> launcher cache over a pluggable executor.

The session owns exactly three things:

  * device-resident slot tables, uploaded once at construction;
  * the plan cache — ``plan.key -> launcher`` — so ``stats.compiles``
    counts the distinct bucketed shapes this session has resolved exactly
    (no compiler runs per key: the kernels take their sizes at run time;
    the name is the reference's, whose counters and profiler read it);
  * request accounting (:class:`EngineStats`).

All backend knowledge lives in the executor (``cuda`` / ``torch`` /
``sharded`` — see ``engine.executors``).  The prepare/execute split is
public API: callers that re-issue the same request shape (e.g.
``runtime.serve.DecodeService``) cache the :class:`DecodePlan` and skip the
host-side preparation entirely.

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
from .plan import DecodePlan, DeviceStream


@dataclasses.dataclass
class EngineStats:
    """Request accounting.  ``compiles`` counts plan-key misses (launchers
    resolved), as the reference's does; it keeps the reference's name
    because ``ServiceStats.compiles``, ``recoil_service_compiles_total`` and
    the profiler's compile records read it in both packages."""

    compiles: int = 0      # plan-key misses: launchers resolved
    cache_hits: int = 0    # decodes served by an already-resolved key
    decodes: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class DecoderSession:
    """Device-resident Recoil decoder with a bucketed plan cache.

    ``device`` defaults to the card (``None`` = ``"cuda"``); with no card
    present that raises — pass ``device="cpu"`` for the plain torch walks.
    The device fixes the backend, read back as :attr:`impl`: ``"cuda"`` (the
    Hopper kernels) on a CUDA device, ``"torch"`` on the CPU, so the plain
    walk never serves a session on the card.  ``impl=`` names that backend
    or ``"sharded"``, and raises for anything else.

    ``impl="sharded"`` shards the split rows over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.DecodeMesh`; ``None`` builds
    :func:`~repro_torch.launch.mesh.make_decode_mesh`, every visible card,
    and raises with none): each shard runs the walk of its mesh entry's
    device on its own slab, and the merged output lives on the mesh's first
    device, which is the session's ``device`` (a ``device=`` that differs
    raises).  See ``repro_torch.parallel.decode_shard``.

    ``packed_lut`` defaults to auto: the §4.4 packed table whenever the
    model fits it.

    ``layout`` is the stream-layout policy: ``"auto"`` (default) runs the
    pointer-free symbol-indexed walk for handles that carry a
    ``words_by_symbol`` permutation and the classic pointer walk otherwise;
    ``"pointer"``/``"symbol"`` force one layout.

    ``policy`` is the bucket-ladder policy: ``None`` (default) keeps the
    legacy pow2/midpoint ladder unless the ``REPRO_TUNING_DB`` environment
    variable points at a tuning database; ``"tuned"`` resolves the best
    persisted profile for this backend (``cuda:cuda:<layout>`` on the card,
    ``cpu:torch:<layout>`` on the CPU, ``<cuda or cpu>:sharded:<layout>``
    for a sharded session: env var, then user cache, then the committed CPU
    defaults); ``"legacy"`` forces the hand-picked ladder; a
    :class:`~repro_torch.core.engine.plan.BucketPolicy` or a tuning
    :class:`~repro_torch.core.tuning.Profile` is used directly.
    ``policy.tag`` joins every plan key, so ladders never alias.
    :attr:`tuning_profile` is the profile it came from (None otherwise); as
    in the reference, the profile's own ``rows_per_block`` is recorded there
    and not applied.

    ``rows_per_block`` is the walk kernels' block size in warps (``None`` =
    128 threads; see
    :func:`~repro_torch.kernels.rans_decode.rans_decode.check_rows_per_block`);
    it joins every plan key.

    ``profiler`` is an injected per-plan-key timer (duck-typed — see
    ``repro_torch.runtime.observability.ExecProfiler``; core never imports
    runtime).  None keeps :meth:`execute` free of timing branches.
    """

    def __init__(self, model: StaticModel, *, device=None, impl=None,
                 packed_lut: bool | None = None, layout: str = "auto",
                 policy=None, rows_per_block: int | None = None,
                 mesh=None, profiler=None):
        from ...kernels.rans_decode.ops import _luts, packed_lut_ok
        if impl == "sharded":
            if mesh is None:
                from ...launch.mesh import make_decode_mesh
                mesh = make_decode_mesh()
            self.device = mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(
                    f"device={device!r} is not the mesh's first device "
                    f"{self.device}, where a sharded session's output lives")
            own = "sharded"
        else:
            if mesh is not None:
                raise ValueError("mesh= is for impl='sharded'")
            self.device = resolve_device("cuda" if device is None else device)
            own = "cuda" if self.device.type == "cuda" else "torch"
            if impl is not None and impl != own:
                raise ValueError(
                    f"impl={impl!r} does not run on {self.device}: the "
                    f"device fixes the impl ({own!r}, or 'sharded' with a "
                    "mesh)")
        self.profiler = profiler
        self.model = model
        if packed_lut is None:
            packed_lut = packed_lut_ok(model)
        elif packed_lut and not packed_lut_ok(model):
            raise ValueError("packed LUT requires 8-bit symbols and n <= 12")
        self.packed_lut = packed_lut
        # Lazy import: tuning sits above plan/executors in the layer order,
        # so the session resolves policies at construction time only.
        from ..tuning import resolve_policy
        self.policy, self.tuning_profile = resolve_policy(
            policy, impl=own, layout=layout,
            platform="cuda" if self.device.type == "cuda" else "cpu")
        # Device-resident slot tables, uploaded once.
        self._luts = _luts(model, packed_lut, self.device)
        self.executor = make_executor(
            own, model, packed_lut, self._luts, self.device, mesh=mesh,
            layout=layout, policy=self.policy, rows_per_block=rows_per_block)
        self._exec: dict[tuple, object] = {}
        self._lock = threading.Lock()   # guards _exec + stats (see header)
        self.stats = EngineStats()

    @property
    def impl(self) -> str:
        """The backend: ``"cuda"`` or ``"torch"`` (fixed by the device), or
        ``"sharded"``."""
        return self.executor.impl

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
        reuse it; the launch runs outside the lock.

        With a profiler injected, the launcher resolution (under the lock,
        recorded as the key's compile once per key miss) and the launch
        (outside it) are timed per plan key.  The launch returns once the
        kernel is queued, so a run time is the host-side enqueue cost, as
        the reference's is its dispatch cost; no synchronize is added."""
        prof = self.profiler
        with self._lock:
            self.stats.decodes += 1
            fn = self._exec.get(plan.key)
            if fn is None:
                if prof is None:
                    fn = self.executor.lower(plan)
                else:
                    t0 = prof.now()
                    fn = self.executor.lower(plan)
                    prof.record_compile("decode", plan.key, prof.now() - t0)
                self._exec[plan.key] = fn
                self.stats.compiles += 1
            else:
                self.stats.cache_hits += 1
        if prof is None:
            return self.executor.run(fn, plan)
        t0 = prof.now()
        out = self.executor.run(fn, plan)
        prof.record_run("decode", plan.key, prof.now() - t0)
        return out

    def decode_batch(self, batch: WalkBatch, stream,
                     n_symbols: int) -> torch.Tensor:
        return self.execute(self.prepare(batch, stream, n_symbols))

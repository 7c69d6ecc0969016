"""Pluggable decode executors behind one interface.

An :class:`Executor` owns one backend's request preparation and lowering:

    upload_stream(words)     -> DeviceStream   (resident on the device)
    plan(batch, ds, n)       -> DecodePlan     (host prep; pure, cacheable)
    lower(plan)              -> launcher       (resolved once per plan key)
    run(fn, plan)            -> device syms    (int32[plan.n_symbols])

:class:`~repro_torch.core.engine.session.DecoderSession` composes an
executor with the plan cache and stats; it never branches on the backend.
Backends:

  * ``cuda``  — the hand-written Hopper kernels (``kernels.rans_decode``)
                on a CUDA device;
  * ``torch`` — the same wrappers on CPU tensors, i.e. the plain torch
                walks (the CPU path and the oracle for the kernels);
  * ``sharded`` — the split rows sharded over a device mesh, each shard
                calling the same wrappers on its own slab; lives in
                ``repro_torch.parallel.decode_shard`` (imported lazily so
                the core engine never touches mesh state).

``cuda`` and ``torch`` read the whole resident stream (or permutation)
and the (S, W) split arrays directly, so they share one ``plan``.  The
split arrays hold the request's real rows; the key carries their bucket,
so its counts match the reference's.  A launcher is bound to what every
plan of its key shares (``n_bits``, ``ways``, ``rows_per_block``); ``run``
passes what differs between plans of one key -- the real walk depth, the
real output length and whether the kept windows tile the output -- at run
time, so a walk runs the steps its splits need and not its key's bucket.

``cuda`` runs a walk that an earlier walk still overlaps on one stream of a
small pool it owns (:data:`WALK_STREAMS`, round-robin), so that independent
requests issued one after another run side by side; the caller's stream
waits for each such walk before ``execute`` returns
(``DecoderSession.execute`` gives the contract).  Every other walk, and
every walk of ``torch`` and ``sharded``, runs on the caller's stream
(``next_lane`` None, ``run_on`` is ``run``).
"""

from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from ..rans import StaticModel
from ..vectorized import WalkBatch
from ...spans import span
from ...kernels.rans_decode.rans_decode import (check_rows_per_block,
                                                load_library,
                                                walk_decode_pointer,
                                                walk_decode_symbol)
from .plan import (BucketPolicy, DecodePlan, DeviceStream, LEGACY_POLICY,
                   SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS, kept_windows_tile,
                   pad_split_arrays, pow2_bucket)

#: Streams a ``cuda`` executor's overlapping walks run on, beside the
#: caller's: four 32-block walks (128 splits, four a block) fit the H100's
#: 132 SMs.  At most 7, so that the pool and the caller's stream fit the
#: card's 8 hardware queues.
WALK_STREAMS = 4


class Executor:
    """Backend contract (see module docstring).  ``luts`` is the session's
    device-resident slot-table tuple ``(sym_lut, f_lut, F_lut)`` — the last
    two are None under the §4.4 packed layout.

    ``layout`` is the stream-layout policy: ``"auto"`` plans the
    pointer-free symbol-indexed walk whenever the handle carries a
    ``words_by_symbol`` permutation and falls back to the pointer walk
    otherwise; ``"pointer"``/``"symbol"`` force one layout (``"symbol"``
    raises on content registered without an emission log).  The selected
    layout joins the plan key, so the two walks never share launchers.

    ``policy`` is the bucket ladder: split rows and walk steps join the
    plan key through ``policy.work``, the output length through
    ``policy.mem``, and ``policy.tag`` joins every key, so two ladders
    never alias one launcher.  Nothing is launched at its bucket: the split
    rows, steps and output keep their real sizes.  Streams reside at their
    pow2 bucket (``upload_stream``) whatever the policy -- a handle is
    shared across executors and must not depend on any one ladder.

    ``rows_per_block`` is the walk kernels' block size in warps (the
    wrappers' docstring; ``None`` = the default 128 threads).  It joins the
    key and is bound into every launcher; the plain walks on the CPU accept
    it and ignore it.
    """

    impl: str = "?"
    device_type: str = "?"
    streams: tuple = ()      # the walk pool; empty: the caller's stream

    def __init__(self, model: StaticModel, packed_lut: bool, luts: tuple,
                 device: torch.device, layout: str = "auto",
                 policy: BucketPolicy | None = None,
                 rows_per_block: int | None = None):
        if layout not in ("auto", "pointer", "symbol"):
            raise ValueError(f"unknown layout policy {layout!r}")
        if device.type != self.device_type:
            raise ValueError(
                f"impl={self.impl!r} runs on {self.device_type}, not {device}")
        check_rows_per_block(rows_per_block, model.params.ways)
        self.model = model
        self.packed_lut = packed_lut
        self.luts = luts
        self.device = device
        self.layout = layout
        self.policy = policy if policy is not None else LEGACY_POLICY
        self.rows_per_block = rows_per_block
        # Per-layout plan counts (picked up by ServiceStats) and stream
        # upload accounting (picked up by the metrics collectors).  plan()
        # and upload_stream() may run from any thread, so bumps take
        # _counts_lock.
        self.layout_plans = {"pointer": 0, "symbol": 0}
        self.stream_uploads = 0
        self.stream_upload_bytes = 0
        self._counts_lock = threading.Lock()

    def _count_layout(self, layout: str) -> None:
        with self._counts_lock:
            self.layout_plans[layout] += 1

    def select_layout(self, ds: DeviceStream) -> str:
        """The layout this request will run under (policy x availability)."""
        if self.layout == "pointer":
            return "pointer"
        if ds.by_symbol is None:
            if self.layout == "symbol":
                raise ValueError(
                    "layout='symbol' requires content registered with an "
                    "emission log (DeviceStream.by_symbol is None)")
            return "pointer"
        return "symbol"

    def upload_stream(self, stream: np.ndarray) -> DeviceStream:
        """Upload the 16-bit words once, as int16 bit patterns, zero-padded
        to their pow2 bucket."""
        host = np.ascontiguousarray(np.asarray(stream))
        if host.size and (int(host.min()) < 0 or int(host.max()) >= 1 << 16):
            raise ValueError("stream words must lie in [0, 2^16)")
        bucket = pow2_bucket(len(host), 1024)
        padded = np.zeros(bucket, np.uint16)
        padded[:len(host)] = host
        with self._counts_lock:
            self.stream_uploads += 1
            self.stream_upload_bytes += int(padded.nbytes)
        return DeviceStream(
            words=torch.as_tensor(padded.view(np.int16), device=self.device),
            host=host, n_words=len(host), bucket=bucket)

    def plan(self, batch: WalkBatch, ds: DeviceStream,
             n_symbols: int) -> DecodePlan:
        layout = self.select_layout(ds)
        self._count_layout(layout)
        p = self.model.params
        W = batch.ways
        s_b = self.policy.work(batch.k.shape[0])
        steps_b = self.policy.work(batch.n_steps)
        out_b = self.policy.mem(n_symbols)
        arrs = pad_split_arrays(batch, batch.k.shape[0], self.device)
        statics = dict(n_bits=p.n_bits, ways=W)
        rpb = self.rows_per_block
        if layout == "symbol":
            _check_sym_alignment(batch, ds, W)
            # The key keeps the reference's word-width field: 16-bit words
            # on both layouts here.
            key = (self.impl, layout, self.policy.tag, self.packed_lut,
                   p.n_bits, W, s_b, steps_b, ds.sym_bucket, "u16", out_b,
                   rpb)
            args = (ds.by_symbol, *self.luts,
                    *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
        else:
            key = (self.impl, layout, self.policy.tag, self.packed_lut,
                   p.n_bits, W, s_b, steps_b, ds.bucket, "u16", out_b, rpb)
            args = (ds.words, *self.luts, *(arrs[f] for f in SPLIT_FIELDS))
        return DecodePlan(key=key, args=args, statics=statics,
                          n_symbols=n_symbols, out_bucket=out_b,
                          layout=layout,
                          covered=kept_windows_tile(batch, n_symbols),
                          n_steps=batch.n_steps, ready=self.inputs_ready())

    def inputs_ready(self):
        """The event a plan's walk waits for before it reads the plan's
        device inputs; None where the walk runs on the stream that wrote
        them."""
        return None

    def next_lane(self):
        """The pool stream (an index into ``streams``) the next walk runs
        on, or None: the caller's stream.  The session calls it under its
        lock."""
        return None

    def run_on(self, fn, plan: DecodePlan, lane) -> torch.Tensor:
        """``run`` on the stream ``next_lane`` picked."""
        return self.run(fn, plan)

    def lower(self, plan: DecodePlan):
        """The launcher for this plan's key: the layout's wrapper bound to
        the plan's shared scalar arguments and the block size."""
        fn = (walk_decode_symbol if plan.layout == "symbol"
              else walk_decode_pointer)
        return functools.partial(fn, **plan.statics,
                                 rows_per_block=self.rows_per_block)

    def run(self, fn, plan: DecodePlan) -> torch.Tensor:
        with span("recoil.walk.launch"):
            res = fn(*plan.args, n_steps=plan.n_steps,
                     n_symbols=plan.n_symbols, covered=plan.covered)
        return res if plan.layout == "symbol" else res[0]


def _check_sym_alignment(batch: WalkBatch, ds: DeviceStream, W: int) -> None:
    """Loud host-side guards for the symbol layout: the walk gathers whole
    W-wide groups, so every permutation base must be group-aligned, and the
    permutation bucket must hold whole groups."""
    bases = batch.sym_bases()
    if bases.size and np.any(bases % W):
        raise ValueError("sym_base entries must be multiples of ways for "
                         "the symbol-indexed layout")
    if ds.sym_bucket % W:
        raise ValueError(
            f"sym_bucket={ds.sym_bucket} is not a multiple of ways={W}")


class TorchExecutor(Executor):
    """The plain torch walks on the CPU (the wrappers' CPU branch)."""

    impl = "torch"
    device_type = "cpu"


class CudaExecutor(Executor):
    """The hand-written Hopper kernels on a CUDA device; walks that overlap
    an earlier one run on the executor's stream pool (module docstring)."""

    impl = "cuda"
    device_type = "cuda"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._index = (self.device.index if self.device.index is not None
                       else torch.cuda.current_device())
        self.streams = tuple(torch.cuda.Stream(self.device)
                             for _ in range(WALK_STREAMS))
        self._ends = tuple(torch.cuda.Event() for _ in self.streams)
        self._caller_end = torch.cuda.Event()
        self._start = torch.cuda.Event()   # the caller's queue at a burst
        self._turn = 0
        self._last_end = None    # the end event of the last walk
        # Pool outputs the allocator may not reuse yet: (storage, the
        # caller's stream, None or an event recorded there once the caller
        # let go of the output).
        self._held = collections.deque()

    def inputs_ready(self):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._index))
        return ev

    def next_lane(self):
        self._release()
        last = self._last_end
        if last is None or last.query():
            return None
        lane = self._turn % len(self.streams)
        self._turn += 1
        return lane

    def _release(self):
        """Hand back to the allocator the pool outputs that the caller has
        let go of, once the caller's stream has passed them.

        An output allocated on a pool stream returns to that stream's
        blocks when it is freed, and a later walk there could overwrite it
        before the caller's stream has run the reads queued on it.  This
        is the wait that ``record_stream`` would add at the free, done here
        instead: a CUDA error then raises to the caller of ``execute``, not
        inside a tensor's destructor, where it aborts the process.  At most
        ``2 * WALK_STREAMS`` entries are looked at a call, so that outputs
        the caller keeps cost no more than that."""
        held = self._held
        for _ in range(min(len(held), 2 * len(self.streams))):
            storage, stream, ev = held.popleft()
            if ev is None:
                if torch._C._storage_Use_Count(storage._cdata) > 1:
                    held.append((storage, stream, None))   # still the caller's
                    continue
                ev = torch.cuda.Event()
                ev.record(stream)
            if not ev.query():
                held.append((storage, stream, ev))

    def lower(self, plan: DecodePlan):
        load_library()   # build + bind once, on the first plan key
        return super().lower(plan)

    def run_on(self, fn, plan: DecodePlan, lane) -> torch.Tensor:
        """``run`` on the caller's stream (``lane`` None: no walk of the
        session was running), or on pool stream ``lane``.

        On the caller's stream the walk waits for what the caller queued,
        as one launch always did, and an event recorded just before it
        marks where the caller's queue stood when the burst began.  On a
        pool stream the walk waits for the plan's inputs and for that
        event, and the caller's stream then waits for the walk: so no walk
        runs ahead of what its caller queued before the burst, and while a
        burst lasts no walk waits on the earlier walks' joins.  The output
        and ``qf`` are allocated on the pool stream; the output is held
        until the caller's stream has passed it (:meth:`_release`).  Each
        stream re-records one end event: a later record is on the same
        stream, so a wait that sees it still covers this walk.  The stream
        is switched by ``set_stream`` (a context manager costs several
        times as much), which also selects the stream's device, so the
        caller's device is selected again after it."""
        caller = torch.cuda.current_stream(self._index)
        if lane is None:
            caller.wait_event(plan.ready)
            self._start.record(caller)
            out = self.run(fn, plan)
            self._caller_end.record(caller)
            self._last_end = self._caller_end
            return out
        stream, end = self.streams[lane], self._ends[lane]
        stream.wait_event(plan.ready)
        stream.wait_event(self._start)
        device = torch.cuda.current_device()
        torch.cuda.set_stream(stream)
        try:
            out = self.run(fn, plan)
        finally:
            torch.cuda.set_stream(caller)
            torch.cuda.set_device(device)
        end.record(stream)
        caller.wait_event(end)
        self._held.append((out.untyped_storage(), caller, None))
        self._last_end = end
        return out


def make_executor(impl: str, model: StaticModel, packed_lut: bool,
                  luts: tuple, device: torch.device, *, mesh=None,
                  layout: str = "auto", policy: BucketPolicy | None = None,
                  rows_per_block: int | None = None) -> Executor:
    if impl == "cuda":
        return CudaExecutor(model, packed_lut, luts, device, layout, policy,
                            rows_per_block)
    if impl == "torch":
        return TorchExecutor(model, packed_lut, luts, device, layout, policy,
                             rows_per_block)
    if impl == "sharded":
        from ...parallel.decode_shard import ShardedExecutor
        return ShardedExecutor(model, packed_lut, luts, mesh=mesh,
                               layout=layout, policy=policy,
                               rows_per_block=rows_per_block)
    raise ValueError(f"unknown impl {impl!r}")

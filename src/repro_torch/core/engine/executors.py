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
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..rans import StaticModel
from ..vectorized import WalkBatch
from ...kernels.rans_decode.rans_decode import (check_rows_per_block,
                                                load_library,
                                                walk_decode_pointer,
                                                walk_decode_symbol)
from .plan import (BucketPolicy, DecodePlan, DeviceStream, LEGACY_POLICY,
                   SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS, kept_windows_tile,
                   pad_split_arrays, pow2_bucket)


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
                          n_steps=batch.n_steps)

    def lower(self, plan: DecodePlan):
        """The launcher for this plan's key: the layout's wrapper bound to
        the plan's shared scalar arguments and the block size."""
        fn = (walk_decode_symbol if plan.layout == "symbol"
              else walk_decode_pointer)
        return functools.partial(fn, **plan.statics,
                                 rows_per_block=self.rows_per_block)

    def run(self, fn, plan: DecodePlan) -> torch.Tensor:
        res = fn(*plan.args, n_steps=plan.n_steps, n_symbols=plan.n_symbols,
                 covered=plan.covered)
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
    """The hand-written Hopper kernels on a CUDA device."""

    impl = "cuda"
    device_type = "cuda"

    def lower(self, plan: DecodePlan):
        load_library()   # build + bind once, on the first plan key
        return super().lower(plan)


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

"""Pluggable decode executors behind one interface.

An :class:`Executor` owns one backend's request preparation and lowering:

    upload_stream(words)     -> DeviceStream   (resident on the device)
    plan(batch, ds, n)       -> DecodePlan     (host prep; pure, cacheable)
    lower(plan)              -> launcher       (resolved once per plan key)
    run(fn, plan)            -> device syms    (bucketed; caller slices)

:class:`~repro_torch.core.engine.session.DecoderSession` composes an
executor with the plan cache and stats; it never branches on the backend.
Backends:

  * ``cuda``  — the hand-written Hopper kernels (``kernels.rans_decode``)
                on a CUDA device;
  * ``torch`` — the same wrappers on CPU tensors, i.e. the plain torch
                walks (the CPU path and the oracle for the kernels).

Both read the whole resident stream (or permutation) and the (S, W) split
arrays directly, so they share one ``plan``.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..rans import StaticModel
from ..vectorized import WalkBatch
from ...kernels.rans_decode.rans_decode import (load_library,
                                                walk_decode_pointer,
                                                walk_decode_symbol)
from .plan import (BucketPolicy, DecodePlan, DeviceStream, LEGACY_POLICY,
                   SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS, pad_split_arrays,
                   perm_dtype_name, pow2_bucket)


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

    ``policy`` is the bucket ladder: every compute-shaped dimension (split
    rows, walk steps, output slots) is padded through ``policy.work``/
    ``policy.mem`` and ``policy.tag`` joins every plan key.  Stream
    residency buckets (``upload_stream``) stay on the fixed pow2 ladder.
    """

    impl: str = "?"
    device_type: str = "?"

    def __init__(self, model: StaticModel, packed_lut: bool, luts: tuple,
                 device: torch.device, layout: str = "auto",
                 policy: BucketPolicy | None = None):
        if layout not in ("auto", "pointer", "symbol"):
            raise ValueError(f"unknown layout policy {layout!r}")
        if device.type != self.device_type:
            raise ValueError(
                f"impl={self.impl!r} runs on {self.device_type}, not {device}")
        self.model = model
        self.packed_lut = packed_lut
        self.luts = luts
        self.device = device
        self.layout = layout
        self.policy = policy if policy is not None else LEGACY_POLICY
        # Per-layout plan counts (picked up by ServiceStats).  plan() may
        # run from any thread, so bumps go through _count_layout's lock.
        self.layout_plans = {"pointer": 0, "symbol": 0}
        self._layout_lock = threading.Lock()

    def _count_layout(self, layout: str) -> None:
        with self._layout_lock:
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
        """Upload the words once, zero-padded to their pow2 bucket."""
        host = np.ascontiguousarray(np.asarray(stream))
        bucket = pow2_bucket(len(host), 1024)
        padded = np.zeros(bucket, np.int32)
        padded[:len(host)] = host.astype(np.int32)
        return DeviceStream(words=torch.as_tensor(padded, device=self.device),
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
        arrs = pad_split_arrays(batch, s_b, self.device)
        statics = dict(n_bits=p.n_bits, ways=W, n_steps=steps_b,
                       n_symbols=out_b)
        if layout == "symbol":
            _check_sym_alignment(batch, ds, W)
            # The permutation dtype (u16 for small assets, u32 otherwise)
            # joins the key: same sym_bucket, different dtype must not alias.
            key = (self.impl, layout, self.policy.tag, self.packed_lut,
                   p.n_bits, W, s_b, steps_b, ds.sym_bucket,
                   perm_dtype_name(ds.by_symbol), out_b)
            args = (ds.by_symbol, *self.luts,
                    *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
        else:
            key = (self.impl, layout, self.policy.tag, self.packed_lut,
                   p.n_bits, W, s_b, steps_b, ds.bucket, "u32", out_b)
            args = (ds.words, *self.luts, *(arrs[f] for f in SPLIT_FIELDS))
        return DecodePlan(key=key, args=args, statics=statics,
                          n_symbols=n_symbols, out_bucket=out_b,
                          layout=layout)

    def lower(self, plan: DecodePlan):
        """The launcher for this plan's key: the layout's wrapper bound to
        the plan's scalar arguments."""
        fn = (walk_decode_symbol if plan.layout == "symbol"
              else walk_decode_pointer)
        return functools.partial(fn, **plan.statics)

    def run(self, fn, plan: DecodePlan) -> torch.Tensor:
        res = fn(*plan.args)
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
                  luts: tuple, device: torch.device, *, layout: str = "auto",
                  policy: BucketPolicy | None = None) -> Executor:
    if impl == "cuda":
        return CudaExecutor(model, packed_lut, luts, device, layout, policy)
    if impl == "torch":
        return TorchExecutor(model, packed_lut, luts, device, layout, policy)
    raise ValueError(f"unknown impl {impl!r}")

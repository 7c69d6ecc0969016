"""Sharded decode over a device mesh: the paper's §3.3 scalability, mesh
edition.

Recoil's pitch is that one bitstream scales to whatever parallelism the
decoder has; on a device mesh that parallelism is the mesh itself.  The
:class:`ShardedExecutor` shards the split rows of a ``WalkBatch`` over
every entry of a :class:`~repro_torch.launch.mesh.DecodeMesh`:

  * **rows**: the split bucket is ``n_shards * policy.work(ceil(S /
    n_shards))`` and shard ``s`` owns padded rows ``[s r, (s + 1) r)``
    of it, the reference's assignment exactly.  Each shard launches only
    its *real* rows (the inert padding rows, ``start = -1``, are left
    out), with the real step count of its own rows; a shard with no real
    row launches nothing.  The slot tables are copied once per distinct
    device at construction;
  * **slabs**: the stream arrives thinned.  A row's walk consumes at most
    one word per walked index, descending from its ``q0``, so its reads
    live in ``[q0 - (start - stop), q0]``; shard ``s`` reads the union
    ``[lo_s, hi_s]`` over its active rows, padded to a common pow2 slab
    bucket (floor 1024), gathered on the device from the resident stream
    (indices clipped to the stream's bucket), and each row's ``q0`` is
    rebased by ``lo_s``.  The symbol layout does the same on the
    permutation: row ``m`` reads symbol indices ``[stop + sym_base, start
    + sym_base]``, ``lo_s`` is rounded down to a whole W-group and
    ``sym_base`` is rebased.  The slabs of the shards on one device are
    the rows of one ``int16[n, slab_b]`` tensor, so every slab is
    contiguous and 16-byte aligned, as the walk kernels' wrappers require;
  * **walks**: each shard calls the same walk wrapper the single-device
    executors call, on its own device's current stream: the Hopper kernel
    on a CUDA mesh, the plain torch walk on a CPU mesh.  Its output is
    its own ``-1``-filled ``int32[n_symbols]``, since its kept windows do
    not tile the output;
  * **merge**: kept output positions are disjoint across splits, so the
    elementwise maximum of the shards' outputs is the decode (the
    reference's ``lax.pmax``).  Each output is brought to the mesh's
    first device with ``.to()`` (a no-op when it is already there) and
    merged with ``torch.maximum``: one code path however the mesh's
    devices repeat.  The result lives on the mesh's first device, the
    session's ``device``.

A mesh whose entries repeat one card runs its shards one after another on
it: the reference's one ``shard_map`` executable over a forced host mesh,
serialised.

Residency: a shard gathers its slab from the handle's resident words (or
permutation) on its own device.  The re-pin cache holds one copy of a
handle's field per device, keyed by (handle, field, device) with a weakref
identity check, and lock-guarded like the reference's: warm traffic moves
no stream bytes.  On the session's device ``.to()`` returns the resident
tensor itself.  An entry is dropped when its handle dies.

Plan keys carry the reference's bucket fields (impl, layout, policy tag,
shard count, axes, packed table, n, W, split bucket, steps bucket, slab
bucket, the symbol layout's word width, out bucket) plus
``rows_per_block``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref

import numpy as np
import torch

from ..core.engine.executors import Executor, _check_sym_alignment
from ..core.engine.plan import (BucketPolicy, DecodePlan, SPLIT_FIELDS,
                                SYMBOL_SPLIT_FIELDS, pad_split_arrays)
from ..kernels.rans_decode.rans_decode import (load_library,
                                               walk_decode_pointer,
                                               walk_decode_symbol)

_FAR = np.int64(1) << 60


@dataclasses.dataclass(frozen=True)
class ShardLaunch:
    """One shard's walk: its position in the mesh, the batch rows it owns
    (``rows = (lo, hi)``, real rows only), its real step count, its device,
    its slab's first index in the stream or permutation (``origin``), the
    words its rows can read from there (``span``, at most the slab bucket),
    and the wrapper's positional arguments (slab, slot tables, split
    fields)."""

    shard: int
    rows: tuple
    n_steps: int
    device: torch.device
    origin: int
    span: int
    args: tuple


def shard_row_ranges(n_rows: int, n_shards: int,
                     rows_per: int) -> list[tuple[int, int]]:
    """The real rows ``[lo, hi)`` of each shard: shard ``s`` owns padded
    rows ``[s rows_per, (s + 1) rows_per)``, of which rows ``>= n_rows``
    are the inert padding."""
    return [(min(s * rows_per, n_rows), min((s + 1) * rows_per, n_rows))
            for s in range(n_shards)]


def shard_windows(row_lo: np.ndarray, row_hi: np.ndarray,
                  active: np.ndarray,
                  ranges: list[tuple[int, int]]) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Each shard's read window ``[lo_s, hi_s]``: the union of its active
    rows' ``[row_lo, row_hi]``, with ``lo_s`` clipped at 0 and an empty
    shard's window of length 0 (``lo_s = hi_s + 1``)."""
    lo = np.empty(len(ranges), np.int64)
    hi = np.empty(len(ranges), np.int64)
    for s, (a, b) in enumerate(ranges):
        act = active[a:b]
        lo[s] = np.where(act, row_lo[a:b], _FAR).min(initial=_FAR)
        hi[s] = np.where(act, row_hi[a:b], -1).max(initial=-1)
    return np.clip(np.minimum(lo, hi + 1), 0, None), hi


def gather_slabs(src: torch.Tensor, origins: torch.Tensor, slab_b: int,
                 bucket: int) -> torch.Tensor:
    """``src[origins[i] + j]`` for ``j < slab_b``, indices clipped to
    ``[0, bucket - 1]``: one ``[len(origins), slab_b]`` tensor on
    ``src``'s device, each row a shard's slab."""
    idx = origins[:, None] + torch.arange(slab_b, device=src.device)
    return src[idx.clamp_(0, bucket - 1)]


def _on(device: torch.device):
    """The device's context for a launch: its CUDA device, or nothing."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _evict(cache: dict, key: tuple, ref: weakref.ref) -> None:
    """Weakref callback: drop a dead handle's entry (if it is still its)."""
    hit = cache.get(key)
    if hit is not None and hit[0] is ref:
        cache.pop(key, None)


class ShardedExecutor(Executor):
    """Multi-device decode over a mesh (see module docstring).

    ``mesh=None`` builds a 1-D mesh over every visible CUDA device
    (:func:`repro_torch.launch.mesh.make_decode_mesh`), which raises with
    no card; any mesh works -- split rows shard over the *product* of its
    axes, so :func:`~repro_torch.launch.mesh.make_smoke_mesh`'s meshes are
    valid too.  The executor's ``device`` is the mesh's first device:
    streams upload there and the merged output lives there.  ``luts`` are
    the session's slot tables on that device.
    """

    impl = "sharded"

    def __init__(self, model, packed_lut: bool, luts: tuple, *, mesh=None,
                 layout: str = "auto", policy: BucketPolicy | None = None,
                 rows_per_block: int | None = None):
        if mesh is None:
            from ..launch.mesh import make_decode_mesh
            mesh = make_decode_mesh()
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.n_shards = int(math.prod(mesh.shape[a] for a in self.axes))
        super().__init__(model, packed_lut, luts, mesh.devices[0], layout,
                         policy, rows_per_block)
        # Slot tables: one copy per distinct device, at construction.
        self.luts_on = {d: tuple(None if t is None else t.to(d)
                                 for t in luts)
                        for d in dict.fromkeys(mesh.devices)}
        self._repl_cache: dict[tuple, tuple[weakref.ref, torch.Tensor]] = {}
        self._repl_lock = threading.Lock()

    @property
    def device_type(self) -> str:
        return self.mesh.devices[0].type

    def _replicated(self, ds, field: str,
                    device: torch.device) -> torch.Tensor:
        """The handle's ``field`` on ``device``, copied at most once per
        live handle and device (see module docstring)."""
        key = (id(ds), field, device)
        with self._repl_lock:
            hit = self._repl_cache.get(key)
            if hit is not None and hit[0]() is ds:
                return hit[1]
            on_dev = getattr(ds, field).to(device)
            ref = weakref.ref(
                ds, lambda r, c=self._repl_cache, k=key: _evict(c, k, r))
            self._repl_cache[key] = (ref, on_dev)
            return on_dev

    def _split_bucket(self, S: int) -> int:
        """Equal inert-padded rows per shard: shard count x per-shard work
        bucket, so ragged split counts still divide the mesh evenly."""
        return self.n_shards * self.policy.work(-(-S // self.n_shards))

    def plan(self, batch, ds, n_symbols: int) -> DecodePlan:
        layout = self.select_layout(ds)
        self._count_layout(layout)
        p = self.model.params
        W = batch.ways
        S = batch.k.shape[0]
        s_b = self._split_bucket(S)
        steps_b = self.policy.work(batch.n_steps)
        out_b = self.policy.mem(n_symbols)
        ranges = shard_row_ranges(S, self.n_shards, s_b // self.n_shards)
        start = batch.start.astype(np.int64)
        stop = batch.stop.astype(np.int64)
        if layout == "symbol":
            _check_sym_alignment(batch, ds, W)
            base = batch.sym_bases().astype(np.int64)
            lo_s, hi_s = shard_windows(stop + base, start + base, start >= 0,
                                       ranges)
            lo_s = (lo_s // W) * W                     # whole-group origin
            field, bucket, rebase = "by_symbol", ds.sym_bucket, "sym_base"
            floor = W
        else:
            q0 = batch.q0.astype(np.int64)
            lo_s, hi_s = shard_windows(q0 - (start - stop), q0, start >= 0,
                                       ranges)
            field, bucket, rebase = "words", ds.bucket, "q0"
            floor = 1
        slab_len = int(np.maximum(hi_s - lo_s + 1, 0).max()) if S else 1
        slab_b = self.policy.mem(max(slab_len, floor), 1024)
        # The symbol key carries the permutation's word width, as the
        # reference's carries its dtype: 16-bit words here.
        width = ("u16",) if layout == "symbol" else ()
        key = (self.impl, layout, self.policy.tag, self.n_shards, self.axes,
               self.packed_lut, p.n_bits, W, s_b, steps_b, slab_b, *width,
               out_b, self.rows_per_block)
        names = SYMBOL_SPLIT_FIELDS if layout == "symbol" else SPLIT_FIELDS
        launches = self._launches(batch, ds, ranges, lo_s, hi_s, slab_b,
                                  field, bucket, rebase, names)
        return DecodePlan(key=key, args=launches,
                          statics=dict(n_bits=p.n_bits, ways=W),
                          n_symbols=n_symbols, out_bucket=out_b,
                          layout=layout, covered=False,
                          n_steps=batch.n_steps)

    def _launches(self, batch, ds, ranges, lo_s, hi_s, slab_b, field,
                  bucket, rebase, names) -> tuple:
        """Per-shard launches: each device's slabs gathered in one indexing
        op, its shards' rows uploaded once, then sliced per shard."""
        host = pad_split_arrays(batch, batch.k.shape[0], torch.device("cpu"))
        owner = np.repeat(np.arange(len(ranges)),
                          [b - a for a, b in ranges])
        host[rebase] = (host[rebase].to(torch.int64)
                        - torch.as_tensor(lo_s[owner])).to(torch.int32)
        g_lo = batch.stop.astype(np.int64) // batch.ways
        depth = batch.g_hi.astype(np.int64) - g_lo + 1
        real = [s for s, (a, b) in enumerate(ranges) if b > a]
        launches = []
        for dev in dict.fromkeys(self.mesh.devices[s] for s in real):
            mine = [s for s in real if self.mesh.devices[s] == dev]
            rows = torch.as_tensor(np.concatenate(
                [np.arange(*ranges[s]) for s in mine]))
            with _on(dev):
                slabs = gather_slabs(self._replicated(ds, field, dev),
                                     torch.as_tensor(lo_s[mine], device=dev),
                                     slab_b, bucket)
                arrs = {f: host[f].index_select(0, rows).to(dev)
                        for f in names}
            at = 0
            for j, s in enumerate(mine):
                a, b = ranges[s]
                n = b - a
                steps = min(batch.n_steps, max(int(depth[a:b].max()), 0))
                launches.append(ShardLaunch(
                    shard=s, rows=(a, b), n_steps=steps, device=dev,
                    origin=int(lo_s[s]), span=int(hi_s[s] - lo_s[s] + 1),
                    args=(slabs[j], *self.luts_on[dev],
                          *(arrs[f][at:at + n] for f in names))))
                at += n
        return tuple(sorted(launches, key=lambda sh: sh.shard))

    def lower(self, plan: DecodePlan):
        """The layout's walk wrapper bound to the plan's shared scalars and
        the block size; on a CUDA mesh the kernel library is built and
        bound here, once."""
        if self.device_type == "cuda":
            load_library()
        fn = (walk_decode_symbol if plan.layout == "symbol"
              else walk_decode_pointer)
        return functools.partial(fn, **plan.statics,
                                 rows_per_block=self.rows_per_block)

    def run(self, fn, plan: DecodePlan) -> torch.Tensor:
        """Each shard's walk on its device, then the merge on the mesh's
        first device (see module docstring)."""
        out = None
        for sh in plan.args:
            with _on(sh.device):
                res = fn(*sh.args, n_steps=sh.n_steps,
                         n_symbols=plan.n_symbols, covered=False)
            part = (res if plan.layout == "symbol" else res[0]).to(
                self.device)
            out = part if out is None else torch.maximum(out, part, out=out)
        if out is None:
            out = torch.full((plan.n_symbols,), -1, dtype=torch.int32,
                             device=self.device)
        return out

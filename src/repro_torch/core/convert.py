"""Plain-array carriers for the system's state.

The codec has no weights: its state is the model tables and the encoded
content.  These converters build the port's objects from plain numpy arrays
and take them apart again, so content made by another implementation (for
example the JAX package's ``StaticModel``/``RecoilPlan``/``WalkBatch``)
crosses over field by field.  The other carrier is the wire itself
(:mod:`.container`).
"""

from __future__ import annotations

import numpy as np

from .rans import RansParams, StaticModel
from .recoil import RecoilPlan, SplitPoint
from .vectorized import WalkBatch

#: WalkBatch's array fields, in declaration order.
BATCH_FIELDS = ("k", "y", "x0", "q0", "g_hi", "start", "stop", "keep_lo",
                "keep_hi", "out_base", "sym_base")


def model_from_arrays(f, F, n_bits: int, ways: int) -> StaticModel:
    """A static model from its quantized frequencies ``f`` (sum 2^n) and
    exclusive CDF ``F`` (len(f) + 1 entries)."""
    f = np.asarray(f, np.uint32)
    F = np.asarray(F, np.uint32)
    if F.shape != (len(f) + 1,) or int(F[-1]) != 1 << n_bits:
        raise ValueError("F must be the exclusive CDF of f, ending at 2^n")
    return StaticModel(f=f, F=F, params=RansParams(n_bits=n_bits, ways=ways))


def plan_from_arrays(offsets, ks, ys, n_symbols: int, n_words: int,
                     ways: int) -> RecoilPlan:
    """A split plan from its stacked metadata: ``offsets`` int[M], ``ks``
    int[M, W] and ``ys`` u32[M, W] (M may be 0)."""
    offsets = np.asarray(offsets, np.int64).reshape(-1)
    ks = np.asarray(ks, np.int64).reshape(len(offsets), ways)
    ys = np.asarray(ys, np.uint32).reshape(len(offsets), ways)
    points = tuple(SplitPoint(offset=int(q), k=k.copy(), y=y.copy())
                   for q, k, y in zip(offsets, ks, ys))
    plan = RecoilPlan(points=points, n_symbols=int(n_symbols),
                      n_words=int(n_words), ways=int(ways))
    plan.validate()
    return plan


def plan_arrays(plan: RecoilPlan) -> dict:
    W = plan.ways
    M = len(plan.points)
    return dict(
        offsets=np.asarray([pt.offset for pt in plan.points], np.int64),
        ks=(np.stack([pt.k for pt in plan.points]).astype(np.int64) if M
            else np.zeros((0, W), np.int64)),
        ys=(np.stack([pt.y for pt in plan.points]).astype(np.uint32) if M
            else np.zeros((0, W), np.uint32)),
        n_symbols=plan.n_symbols, n_words=plan.n_words, ways=W)


def batch_from_arrays(arrays: dict, n_steps: int, ways: int) -> WalkBatch:
    """A WalkBatch from a dict of its split arrays (``sym_base`` optional)."""
    dtypes = dict(y=np.uint32, x0=np.uint32)
    fields = {name: np.asarray(arrays[name], dtypes.get(name, np.int32))
              for name in BATCH_FIELDS if arrays.get(name) is not None}
    return WalkBatch(**fields, n_steps=int(n_steps), ways=int(ways))


def batch_arrays(batch: WalkBatch) -> dict:
    return {name: getattr(batch, name) for name in BATCH_FIELDS}

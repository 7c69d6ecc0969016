"""Persistent decode engine: device-resident tables + a bucketed plan cache.

  * ``plan``      — the :class:`DecodePlan` IR (bucket selection, inert-row
                    padding, arg assembly, cache keying) and the microbatch
                    fusion primitive :func:`concat_walk_batches`;
  * ``executors`` — the ``cuda`` (Hopper kernels) and ``torch`` (plain CPU
                    walks) backends behind one plan/lower/run interface;
  * ``session``   — :class:`DecoderSession`, a thin plans -> launchers cache
                    with exact accounting.
"""

from .plan import (BucketPolicy, DecodePlan, DeviceStream, LEGACY_POLICY, LegacyBucketPolicy, SPLIT_FIELDS,
                   SYMBOL_SPLIT_FIELDS, chunk_bounds, concat_walk_batches,
                   derive_symbol_layout, pad_split_arrays, pow2_bucket,
                   with_symbol_layout, work_bucket)
from .executors import (CudaExecutor, Executor, TorchExecutor,
                        make_executor)
from .session import DecoderSession, EngineStats

__all__ = [
    "BucketPolicy", "CudaExecutor", "DecodePlan", "DecoderSession",
    "DeviceStream", "EngineStats", "Executor", "LEGACY_POLICY",
    "LegacyBucketPolicy", "SPLIT_FIELDS", "SYMBOL_SPLIT_FIELDS",
    "TorchExecutor", "chunk_bounds", "concat_walk_batches",
    "derive_symbol_layout", "make_executor", "pad_split_arrays",
    "pow2_bucket", "with_symbol_layout", "work_bucket",
]

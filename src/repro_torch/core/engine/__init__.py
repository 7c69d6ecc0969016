"""Persistent decode engine: device-resident tables + a bucketed plan cache.

  * ``plan``      — the bucket policies (:class:`BucketPolicy`), the
                    :class:`DecodePlan` IR (bucket selection, inert-row
                    padding, arg assembly, cache keying), the microbatch
                    fusion primitive :func:`concat_walk_batches` and the
                    chunk axis :func:`chunk_walk_batch`;
  * ``executors`` — the ``cuda`` (Hopper kernels, each walk on one stream
                    of a pool of :data:`WALK_STREAMS`) and ``torch`` (plain
                    CPU walks) backends behind one plan/lower/run interface;
  * ``session``   — :class:`DecoderSession`, a thin plans -> launchers cache
                    with exact accounting.
"""

from .plan import (BucketPolicy, ChunkSpec, DecodePlan, DeviceStream,
                   LEGACY_POLICY, LadderBucketPolicy, LegacyBucketPolicy,
                   SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS, chunk_bounds,
                   chunk_walk_batch, concat_walk_batches,
                   derive_symbol_layout, kept_windows_tile, legacy_rungs,
                   pad_split_arrays, pow2_bucket, with_symbol_layout,
                   work_bucket)
from .executors import (CudaExecutor, Executor, TorchExecutor,
                        WALK_STREAMS, make_executor)
from .session import DecoderSession, EngineStats

__all__ = [
    "BucketPolicy", "ChunkSpec", "CudaExecutor", "DecodePlan",
    "DecoderSession", "DeviceStream", "EngineStats", "Executor",
    "LEGACY_POLICY", "LadderBucketPolicy", "LegacyBucketPolicy",
    "SPLIT_FIELDS", "SYMBOL_SPLIT_FIELDS", "TorchExecutor", "WALK_STREAMS",
    "chunk_bounds", "chunk_walk_batch", "concat_walk_batches",
    "derive_symbol_layout",
    "kept_windows_tile", "legacy_rungs", "make_executor",
    "pad_split_arrays", "pow2_bucket", "with_symbol_layout", "work_bucket",
]

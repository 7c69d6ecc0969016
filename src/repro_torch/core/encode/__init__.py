"""Ingest engine: W-way interleaved encode + Def-4.1 split planning on the
device, the ingest counterpart of ``core.engine``.

  * ``ops``       — the encode scan and split planner (Hopper kernels on
                    the card, plain torch on the CPU), emission compaction
                    and the one-call :func:`~.ops.ingest_pipeline`;
  * ``plan``      — the :class:`EncodePlan` (device grids + real sizes);
  * ``executors`` — request preparation (single, extend, batch) and the
                    pipeline call;
  * ``session``   — :class:`EncoderSession`: ``ingest``/``encode``/
                    ``ingest_batch``/``extend`` with the resume LRU.

``DecodeService.ingest(name, symbols, n_splits)`` (``runtime.serve``) feeds
the engine's device-resident stream straight into registration.
"""

from .plan import EncodePlan
from .executors import EncodeExecutor
from .session import EncoderSession, EncodeStats, IngestResult

__all__ = [
    "EncodePlan", "EncodeExecutor", "EncoderSession", "EncodeStats",
    "IngestResult",
]

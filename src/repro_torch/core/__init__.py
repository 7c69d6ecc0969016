"""Recoil core — the paper's contribution as a composable library.

  rans         — parameters, quantized models, scalar oracles (Defs 2.1/2.2)
  interleaved  — W-way oracle codecs + emission log (§2.2, Fig. 1)
  vectorized   — host group-stepped encoder, plain torch walk decodes
  heuristic    — Def 4.1 split-point selection
  recoil       — split planning / combining / decoding (§3, §4.1-4.2)
  metadata     — §4.3 bit-packed serialization (Tables 1-2)
  conventional — partitioning-symbols baseline (§2.3)
  container    — on-wire formats for variations (a)-(e)
  convert      — plain-array carriers for models, plans and walk batches
  engine       — persistent DecoderSession (device-resident tables, bucketed
                 plan cache, Hopper kernels on the card)

The modules without torch code are copies of the JAX package's; tests hold
them byte-equal to the originals.
"""

from .rans import DEFAULT_PARAMS, RansParams, StaticModel  # noqa: F401
from .interleaved import (EncodedStream, SplitState,  # noqa: F401
                          decode_interleaved, encode_interleaved)
from .recoil import (RecoilPlan, SplitPoint, build_split_states,  # noqa: F401
                     combine_plan, decode_recoil, plan_splits)
from .metadata import deserialize_plan, serialize_plan  # noqa: F401
from .conventional import (ConventionalEncoded, decode_conventional,  # noqa: F401
                           encode_conventional)
from .vectorized import (WalkBatch, decode_conventional_fast,  # noqa: F401
                         decode_recoil_fast, encode_interleaved_fast,
                         walk_decode_batch)
from .engine import (BucketPolicy, DecoderSession, DeviceStream,  # noqa: F401
                     pow2_bucket, work_bucket)

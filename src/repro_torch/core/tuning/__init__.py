"""Measurement-driven execution autotuning — forks of the JAX package's.

``db``    — the versioned on-disk tuning database: :class:`Profile`
            (tuned ladders + executor parameters per
            ``platform:impl:layout``), :class:`TuningDB`, and the
            session-facing :func:`resolve_policy` (legacy unless opted in).
``tuner`` — the :class:`Autotuner` loop: observe a workload's bucket
            requests, measure real launcher-resolve/execute costs on the
            card (CUDA events) or the CPU, derive breakpoint ladders +
            microbatch quantization by DP, persist.

Layering: this package sits ABOVE ``engine.plan`` (policies) and below
nothing — sessions import it lazily at construction time only, so the
plan/executor layer never depends on tuning.
"""

from .db import (ENV_DB, Profile, SCHEMA_VERSION, TuningDB,
                 TuningSchemaError, builtin_db_path, default_db_path,
                 platform_of, profile_key, resolve_policy, resolve_profile,
                 user_db_path)
from .tuner import (Autotuner, RecordingBucketPolicy, TuningWorkload,
                    derive_quantized_sizes, derive_work_ladder)

__all__ = [
    "Autotuner", "ENV_DB", "Profile", "RecordingBucketPolicy",
    "SCHEMA_VERSION", "TuningDB", "TuningSchemaError", "TuningWorkload",
    "builtin_db_path", "default_db_path", "derive_quantized_sizes",
    "derive_work_ladder", "platform_of", "profile_key", "resolve_policy",
    "resolve_profile", "user_db_path",
]

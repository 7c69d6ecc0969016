"""Versioned on-disk tuning database — a fork of the JAX package's.

A :class:`Profile` is one tuned configuration for a ``platform:impl:layout``
triple — the bucket ladders, executor parameters, and microbatch
quantization sizes the autotuner derived from real launcher-resolve/execute
measurements, plus the workload signature those measurements were taken
under (so a later tuner invocation can prove the profile is still current
and skip every measurement).

A :class:`TuningDB` is a schema-versioned JSON file of profiles, in the
reference's schema: a database either package writes loads in the other.
Three databases stack, most specific first:

  1. ``$REPRO_TUNING_DB``         — explicit, e.g. a bench/CI artifact;
  2. ``~/.cache/repro-recoil-torch/tuning.json`` — the user cache the tuner
     writes by default (its own directory: neither package's tuner or
     tests rewrite the other's cache);
  3. ``profiles/cpu_default.json`` — committed conservative CPU defaults
     (a byte copy of the reference's: a hand-written ladder, no timing).

Sessions consult the stack only when asked (``policy="tuned"``, a profile
object, or ``$REPRO_TUNING_DB`` present); the default remains the legacy
pow2/midpoint ladder, so tuning can never change behavior behind the back
of code that did not opt in.  Lookup falls back along
``platform:impl:layout`` → ``platform:impl:*`` → ``platform:*:*`` → legacy.

What differs from the reference: ``platform`` is the session's device type,
``"cuda"`` or ``"cpu"`` (the reference asks ``jax.default_backend()``), so
the port's keys read ``cuda:cuda:<layout>`` on the card and
``cpu:torch:<layout>`` on the CPU (:func:`platform_of`); a sharded session,
whose impl runs on either, passes its mesh's device type through
:func:`resolve_policy`'s ``platform`` (``cuda:sharded:<layout>``,
``cpu:sharded:<layout>``); and the user cache's directory.
``tests/test_torch_host.py`` holds the code to the reference's apart from
those hunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile

from ..engine.plan import BucketPolicy, LEGACY_POLICY, LadderBucketPolicy

SCHEMA_VERSION = 1

ENV_DB = "REPRO_TUNING_DB"


class TuningSchemaError(ValueError):
    """The on-disk database's schema version is not loadable here."""


def profile_key(platform: str, impl: str, layout: str) -> str:
    return f"{platform}:{impl}:{layout}"


def default_db_path() -> pathlib.Path:
    """Where the tuner persists by default: ``$REPRO_TUNING_DB`` if set,
    else the user cache."""
    env = os.environ.get(ENV_DB)
    if env:
        return pathlib.Path(env)
    return user_db_path()


def user_db_path() -> pathlib.Path:
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return pathlib.Path(cache) / "repro-recoil-torch" / "tuning.json"


def builtin_db_path() -> pathlib.Path:
    return pathlib.Path(__file__).parent / "profiles" / "cpu_default.json"


@dataclasses.dataclass(frozen=True)
class Profile:
    """One tuned configuration (see module docstring).

    ``work_ladder`` / ``mem_ladder`` feed a
    :class:`~repro_torch.core.engine.plan.LadderBucketPolicy` (an empty mem
    ladder keeps the pow2 fallback for memory dims — the residency-shared
    contract).  ``rows_per_block`` / ``microbatch_sizes`` are the executor
    parameters the sweep settled on (``None`` / empty = keep defaults).
    ``workload_sig`` hashes the observed size distribution the profile was
    measured under; ``measurements`` counts the timed probes that built it
    (0 for committed defaults).  ``meta`` carries the fitted cost model for
    audit (compile seconds, execute slope, probe points).
    """

    key: str
    work_ladder: tuple
    mem_ladder: tuple = ()
    rows_per_block: int | None = None
    microbatch_sizes: tuple = ()
    workload_sig: str = ""
    measurements: int = 0
    meta: dict = dataclasses.field(default_factory=dict)

    def policy(self) -> BucketPolicy:
        """The pluggable ladder, tagged by profile key + ladder digest so
        two tuned profiles (or tuned vs legacy) can never alias one
        launcher in a session cache."""
        pol = LadderBucketPolicy(self.work_ladder, self.mem_ladder)
        return LadderBucketPolicy(self.work_ladder, self.mem_ladder,
                                  tag=f"tuned:{self.key}:"
                                      f"{pol.tag.split(':', 1)[1]}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["work_ladder"] = list(self.work_ladder)
        d["mem_ladder"] = list(self.mem_ladder)
        d["microbatch_sizes"] = list(self.microbatch_sizes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Profile":
        return cls(key=d["key"],
                   work_ladder=tuple(int(v) for v in d["work_ladder"]),
                   mem_ladder=tuple(int(v) for v in d.get("mem_ladder", ())),
                   rows_per_block=d.get("rows_per_block"),
                   microbatch_sizes=tuple(
                       int(v) for v in d.get("microbatch_sizes", ())),
                   workload_sig=d.get("workload_sig", ""),
                   measurements=int(d.get("measurements", 0)),
                   meta=dict(d.get("meta", {})))


class TuningDB:
    """Schema-versioned profile store (one JSON file)."""

    def __init__(self, profiles: dict | None = None,
                 path: pathlib.Path | None = None):
        self.profiles: dict[str, Profile] = dict(profiles or {})
        self.path = pathlib.Path(path) if path is not None else None

    @classmethod
    def load(cls, path) -> "TuningDB":
        """Load a database; a missing file is an empty database (the tuner
        creates it on save), a schema mismatch is a loud error — a silent
        fallback would make CI's 0-re-measurement guard meaningless."""
        path = pathlib.Path(path)
        if not path.exists():
            return cls(path=path)
        with open(path) as f:
            raw = json.load(f)
        schema = raw.get("schema")
        if schema != SCHEMA_VERSION:
            raise TuningSchemaError(
                f"tuning DB {path} has schema {schema!r}; this build reads "
                f"schema {SCHEMA_VERSION} — re-run the autotuner")
        profiles = {k: Profile.from_dict(v)
                    for k, v in raw.get("profiles", {}).items()}
        return cls(profiles, path=path)

    def save(self, path=None) -> pathlib.Path:
        path = pathlib.Path(path) if path is not None else self.path
        if path is None:
            raise ValueError("TuningDB has no path; pass save(path=...)")
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"schema": SCHEMA_VERSION,
                   "profiles": {k: p.to_dict()
                                for k, p in sorted(self.profiles.items())}}
        # Atomic replace: a concurrent reader never sees a torn file.
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.path = path
        return path

    def put(self, profile: Profile) -> None:
        self.profiles[profile.key] = profile

    def get(self, key: str) -> Profile | None:
        """Exact key, then wildcard fallback (impl, then layout+impl)."""
        hit = self.profiles.get(key)
        if hit is not None:
            return hit
        platform, impl, _layout = key.split(":", 2)
        for cand in (f"{platform}:{impl}:*", f"{platform}:*:*"):
            hit = self.profiles.get(cand)
            if hit is not None:
                return hit
        return None


def _db_stack() -> list:
    """The database stack, most specific first (see module docstring).
    The env-pinned DB propagates load errors (the caller asked for exactly
    that file); cache/builtin tiers skip quietly when unreadable."""
    stack = []
    env = os.environ.get(ENV_DB)
    if env:
        stack.append(TuningDB.load(env))
    for path in (user_db_path(), builtin_db_path()):
        try:
            stack.append(TuningDB.load(path))
        except (TuningSchemaError, OSError, json.JSONDecodeError):
            continue
    return stack


def platform_of(impl: str) -> str:
    """The profile platform of a port impl: the device type it runs on
    (``"cuda"`` for the Hopper kernels, ``"cpu"`` for the plain torch
    walks).  A session's impl is fixed by its device; ``"sharded"`` runs
    on either, so its caller passes the platform."""
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r} (the port's impls are "
                         "'cuda' and 'torch')")
    return "cuda" if impl == "cuda" else "cpu"


def resolve_profile(*, impl: str, layout: str,
                    platform: str | None = None) -> Profile | None:
    """Best persisted profile for this (backend, impl, layout), or None."""
    if platform is None:
        platform = platform_of(impl)
    key = profile_key(platform, impl, layout)
    for db in _db_stack():
        hit = db.get(key)
        if hit is not None:
            return hit
    return None


def resolve_policy(policy, *, impl: str, layout: str,
                   platform: str | None = None
                   ) -> tuple[BucketPolicy, Profile | None]:
    """Session-facing policy resolution (DecoderSession / EncoderSession).

    ``None`` — legacy, unless ``$REPRO_TUNING_DB`` is set (explicit opt-in
    via environment); ``"legacy"`` / ``"tuned"`` by name; a
    :class:`Profile` or :class:`BucketPolicy` used directly.  Returns the
    policy plus the profile it came from (None for legacy/ad-hoc ladders).
    ``platform`` is :func:`resolve_profile`'s (default: the impl's).
    """
    if policy is None:
        policy = "tuned" if os.environ.get(ENV_DB) else "legacy"
    if isinstance(policy, BucketPolicy):
        return policy, None
    if isinstance(policy, Profile):
        return policy.policy(), policy
    if policy == "legacy":
        return LEGACY_POLICY, None
    if policy == "tuned":
        prof = resolve_profile(impl=impl, layout=layout, platform=platform)
        if prof is None:
            return LEGACY_POLICY, None
        return prof.policy(), prof
    raise ValueError(
        f"unknown bucket policy {policy!r} (None, 'legacy', 'tuned', a "
        "BucketPolicy, or a tuning Profile)")

"""Measurement-driven autotuner for bucket ladders + executor parameters —
a fork of the JAX package's.

The engine's hand-picked ladder (pow2 + 1.5x midpoints) bounds padded
compute at ~1.5x per warm dispatch — a guess about the compile/execute
trade, not a measurement.  The tuner replaces the guess:

  1. **observe** — plan (host prep only, no launch) a representative
     request-size sweep under a :class:`RecordingBucketPolicy`, producing a
     :class:`TuningWorkload`: the multiset of every work/mem dimension the
     executor actually bucketed (scan steps, split rows, ...);
  2. **measure** — time real compiles and warm executes on the running
     backend at a few probe step-buckets (a :class:`_ProbePolicy` pins the
     steps bucket exactly without disturbing the other dims), then fit the
     linear cost model ``execute(v) ~= a + b*v`` and the per-executable
     compile cost ``C``;
  3. **derive** — dynamic program over the observed work values: choose
     bucket breakpoints minimizing ``#buckets*C + b * sum(padded work)``
     over the workload (amortized compile + padded compute), then union
     the legacy rungs below the horizon so dimensions the workload never
     exercised keep the seed ladder's padding bound;
  4. **persist** — write a :class:`~repro_torch.core.tuning.db.Profile`
     keyed by ``platform:impl:layout`` with the workload signature, so the next
     invocation over the same workload returns the stored profile with
     **zero** re-measurements.

Executor parameters ride the same loop: microbatch quantization sizes are
the same breakpoint DP over batch sizes ``1..max_batch`` (compile-per-
distinct-fused-shape vs padded per-request work), and the walk kernels'
``rows_per_block`` candidates are timed on the card or structurally
validated (plan/lower/run + bit-exact output) on the CPU, where timing them
would measure the plain torch walk, not the kernels.

What differs from the reference (``tests/test_torch_host.py`` holds the
code to the reference's apart from these hunks):

  * **Timing.**  On the card a warm probe and a sweep candidate are timed
    with CUDA events queued behind a device sleep and read after a
    synchronize, so they measure the launches, not the host's enqueue; on
    the CPU with ``time.perf_counter`` (the reference waits with
    ``jax.block_until_ready``).
  * **"Compile"** is resolving a launcher: ``executor.lower`` plus, on the
    card, the first load of the kernel library.  It is a host cost, so it
    is read on the host's clock: the first call's enqueue less a warm
    call's (on the card this also holds whatever else the first call does
    on the host, such as allocating).  The probe still asserts that its
    bucket resolves once (``stats.compiles == 1``).
  * **A wrong block raises.**  A sweep candidate whose output is not the
    input symbols raises where the reference marks it invalid and moves
    on: nothing gives way quietly to another block.
  * **Backends.**  ``Autotuner(device=...)`` (default ``"cuda"``, which
    raises without a card) fixes the impl as a session's device does:
    ``"cuda"`` or ``"torch"``; the sweep runs on ``"cuda"`` where the
    reference runs on ``"pallas"``.
  * **The degenerate case.**  A launcher is a ``functools.partial`` over
    kernels that take their sizes at run time, and the kernels walk each
    split's real steps (the bucket only keys the plan), so the fitted
    compile cost is close to zero and the execute cost barely moves with the
    steps bucket.  The dynamic program then keeps almost every observed
    value as its own rung.  The program and the database are ported
    unchanged all the same; ``LEGACY_POLICY`` stays the default, as in the
    reference, and a profile reaches a session only when asked for.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from ...device import resolve_device
from ..engine.plan import (BucketPolicy, LEGACY_POLICY, legacy_rungs,
                           pow2_bucket, work_bucket)
from .db import Profile, TuningDB, default_db_path, platform_of, profile_key

# Cycles of the device sleep queued ahead of a timed call on the card (about
# 5 ms at the H100's top clock): long enough to hide the host's enqueue.
_SLEEP_CYCLES = 10_000_000


class RecordingBucketPolicy(BucketPolicy):
    """Pass-through policy that records every bucket request (natural
    sizes, pre-padding).  Tag mirrors the inner policy: recording must not
    change which executable a plan keys to."""

    def __init__(self, inner: BucketPolicy | None = None):
        self.inner = inner if inner is not None else LEGACY_POLICY
        self.tag = self.inner.tag
        self.work_sizes: collections.Counter = collections.Counter()
        self.mem_sizes: collections.Counter = collections.Counter()

    def work(self, n: int, floor: int = 1) -> int:
        self.work_sizes[max(int(n), int(floor), 1)] += 1
        return self.inner.work(n, floor)

    def mem(self, n: int, floor: int = 1) -> int:
        self.mem_sizes[max(int(n), int(floor), 1)] += 1
        return self.inner.mem(n, floor)

    def workload(self) -> "TuningWorkload":
        return TuningWorkload(dict(self.work_sizes), dict(self.mem_sizes))


@dataclasses.dataclass
class TuningWorkload:
    """Observed size distribution: value -> occurrence count per dim kind."""

    work_sizes: dict
    mem_sizes: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_sizes(cls, sizes) -> "TuningWorkload":
        return cls(dict(collections.Counter(int(s) for s in sizes)))

    def signature(self) -> str:
        """Stable content hash — the tuning DB's re-measurement guard."""
        payload = {"work": sorted(self.work_sizes.items()),
                   "mem": sorted(self.mem_sizes.items())}
        return hashlib.sha1(
            json.dumps(payload, separators=(",", ":")).encode()).hexdigest()


class _ProbePolicy(BucketPolicy):
    """Pin ONE work value's bucket to an exact probe rung, legacy ladder
    everywhere else.  ``work()`` serves several dimensions (scan steps AND
    split rows), so a plain single-rung ladder would explode the row
    bucket; matching on the natural value keeps every other dim untouched.
    """

    def __init__(self, match: int, value: int):
        self.match = int(match)
        self.value = int(value)
        self.tag = f"probe:{self.match}:{self.value}"

    def work(self, n: int, floor: int = 1) -> int:
        if max(int(n), int(floor), 1) == self.match:
            return self.value
        return work_bucket(n, floor)

    def mem(self, n: int, floor: int = 1) -> int:
        return pow2_bucket(n, floor)


def _breakpoint_dp(vals, counts, compile_cost: float,
                   unit_cost: float) -> list:
    """Optimal bucket tops over ``vals`` (ascending, with per-value hit
    ``counts``): minimize ``#buckets * compile_cost + unit_cost *
    sum(bucket_top * hits)`` — amortized compile plus padded work.  The
    padded-work term differs from true waste by the constant ``unit_cost *
    sum(v*c)``, so the argmin is the same.  O(k^2) over distinct values."""
    k = len(vals)
    if k == 0:
        return []
    pc = [0.0] * (k + 1)
    for i, c in enumerate(counts):
        pc[i + 1] = pc[i] + c
    inf = float("inf")
    dp = [inf] * (k + 1)
    dp[0] = 0.0
    arg = [0] * (k + 1)
    for i in range(1, k + 1):
        for j in range(1, i + 1):
            cost = (dp[j - 1] + compile_cost
                    + unit_cost * vals[i - 1] * (pc[i] - pc[j - 1]))
            if cost < dp[i]:
                dp[i] = cost
                arg[i] = j
    tops = []
    i = k
    while i > 0:
        tops.append(vals[i - 1])
        i = arg[i] - 1
    return sorted(tops)


def derive_work_ladder(work_sizes: dict, compile_s: float, slope_s: float,
                       *, horizon: int = 100) -> tuple:
    """Measured-breakpoint ladder over the observed work values, unioned
    with the legacy rungs up to the horizon so any dimension the workload
    never exercised (small split-row counts, future sizes below the max)
    keeps the seed ladder's <= 1.5x padding bound.  ``horizon`` scales the
    observation counts to expected warm hits per compile."""
    vals = sorted(v for v in work_sizes if v >= 1)
    if not vals:
        return tuple(legacy_rungs(1, 1024))
    counts = [work_sizes[v] * horizon for v in vals]
    tops = _breakpoint_dp(vals, counts, max(compile_s, 0.0),
                          max(slope_s, 1e-12))
    return tuple(sorted(set(tops) | set(legacy_rungs(1, vals[-1]))))


def derive_quantized_sizes(compile_s: float, item_s: float, max_batch: int,
                           *, horizon: int = 100) -> tuple:
    """Microbatch quantization set for ``AdaptiveController`` /
    ``broker.warm()``: the same breakpoint DP over batch sizes
    ``1..max_batch`` (uniform assumed arrival mix) with per-request cost
    ``item_s`` — one compiled fused shape per chosen size vs padded
    requests on every dispatch.  Always contains ``max_batch`` (the
    controller clamps there)."""
    vals = list(range(1, max(int(max_batch), 1) + 1))
    counts = [horizon] * len(vals)
    tops = _breakpoint_dp(vals, counts, max(compile_s, 0.0),
                          max(item_s, 1e-12))
    return tuple(sorted(set(tops) | {vals[-1]}))


class Autotuner:
    """Measure compile/execute costs on the running backend and derive a
    persisted :class:`Profile` (see module docstring).

    ``model=None`` synthesizes the standard bench model (exponential
    lam=50 symbols, 256-slot alphabet, n_bits=11, ways=32).  ``repeats``
    is the warm-execute median window per probe; ``max_probes`` caps the
    timed compile+execute probes per invocation.  ``self.measurements``
    counts timed probes across the tuner's lifetime — a DB hit performs
    none.  ``device`` (default ``"cuda"``; raises without a card) fixes the
    impl, ``"cuda"`` or ``"torch"``; ``impl=`` is accepted for the
    reference's signature and raises unless it names that backend.
    """

    def __init__(self, model=None, *, device="cuda", impl: str | None = None,
                 layout: str = "auto", repeats: int = 3, max_probes: int = 4,
                 n_splits: int = 16, seed: int = 7,
                 platform: str | None = None):
        self.device = resolve_device(device)
        own = "cuda" if self.device.type == "cuda" else "torch"
        if impl is not None and impl != own:
            raise ValueError(
                f"impl={impl!r} does not run on {self.device}: the device "
                f"fixes the impl ({own!r})")
        impl = own
        if model is None:
            from ..rans import RansParams, StaticModel
            rng = np.random.default_rng(seed)
            syms = np.minimum(rng.exponential(50.0, size=1 << 16)
                              .astype(np.int64), 255)
            model = StaticModel.from_symbols(
                syms, 256, RansParams(n_bits=11, ways=32))
        self.model = model
        self.impl = impl
        self.layout = layout
        self.repeats = max(int(repeats), 2)
        self.max_probes = max(int(max_probes), 2)
        self.n_splits = n_splits
        self.seed = seed
        if platform is None:
            platform = platform_of(impl)
        self.platform = platform
        self.measurements = 0
        self._reqs: dict[int, dict] = {}

    # ------------------------------------------------------------------
    # Fixtures
    # ------------------------------------------------------------------

    def _request(self, n: int) -> dict:
        """Encoded probe content of ``n`` symbols (cached per size)."""
        req = self._reqs.get(n)
        if req is None:
            from .. import recoil
            from ..recoil import build_split_states
            from ..vectorized import WalkBatch, encode_interleaved_fast
            rng = np.random.default_rng(self.seed + n)
            syms = np.minimum(rng.exponential(50.0, size=n)
                              .astype(np.int64), 255)
            enc = encode_interleaved_fast(syms, self.model)
            plan = recoil.plan_splits(enc, min(self.n_splits, max(n // 64,
                                                                  1)))
            batch = WalkBatch.from_splits(
                build_split_states(plan, enc.final_states), plan.ways)
            req = {"n": n, "syms": syms, "enc": enc, "batch": batch}
            self._reqs[n] = req
        return req

    def _session(self, policy: BucketPolicy, **kw):
        from ..engine.session import DecoderSession
        return DecoderSession(self.model, device=self.device,
                              layout=self.layout, policy=policy, **kw)

    # ------------------------------------------------------------------
    # Observe
    # ------------------------------------------------------------------

    def observe(self, sizes) -> TuningWorkload:
        """Plan (host prep only — no launcher, no launch) each request size
        under a recording policy; the result is the exact multiset of bucket
        requests this traffic makes."""
        rec = RecordingBucketPolicy()
        sess = self._session(rec)
        for n in sizes:
            req = self._request(int(n))
            ds = sess.upload_stream(req["enc"].stream)
            sess.prepare(req["batch"], ds, req["n"])
        return rec.workload()

    # ------------------------------------------------------------------
    # Measure
    # ------------------------------------------------------------------

    def _probe_steps(self, workload: TuningWorkload) -> list:
        """Probe rungs: the largest observed work values (steps-dominant),
        evenly thinned to ``max_probes``; padded from the legacy ladder
        when the workload is too small to fit a slope."""
        vals = sorted(v for v in workload.work_sizes if v >= 64)
        if len(vals) < 2:
            vals = sorted(set(vals) | {1024, 2048})
        if len(vals) > self.max_probes:
            idx = np.linspace(0, len(vals) - 1, self.max_probes)
            vals = sorted({vals[int(round(i))] for i in idx})
        return vals

    def _timed(self, fn) -> tuple:
        """``(host_s, device_s)`` of one ``fn()``.  On the card the host's
        seconds are its enqueue (a launcher resolved inside ``fn`` shows
        there), and the device's are read after a synchronize from CUDA
        events queued behind a device sleep, so that they bracket the
        launches and not the host's enqueue; on the CPU both are the
        ``perf_counter`` time of the call."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            s = time.perf_counter() - t0
            return s, s
        torch.cuda.synchronize(self.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        e0.record()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize(self.device)
        return host_s, e0.elapsed_time(e1) * 1e-3

    def _measure_probe(self, steps: int) -> tuple:
        """One timed probe at an exact steps bucket: returns
        ``(compile_seconds, warm_execute_seconds)``: the first call's host
        seconds beyond a warm call's, and a warm call's device seconds."""
        W = self.model.params.ways
        req = self._request(int(steps) * W)
        nat = req["batch"].n_steps
        sess = self._session(_ProbePolicy(nat, steps))
        ds = sess.upload_stream(req["enc"].stream)
        plan = sess.prepare(req["batch"], ds, req["n"])
        first_s, _ = self._timed(lambda: sess.execute(plan))
        warm = [self._timed(lambda: sess.execute(plan))
                for _ in range(self.repeats)]
        warm_host_s = float(np.median([h for h, _ in warm]))
        warm_s = float(np.median([d for _, d in warm]))
        self.measurements += 1
        assert sess.stats.compiles == 1, "probe bucket must compile once"
        return max(first_s - warm_host_s, 0.0), warm_s

    def measure(self, workload: TuningWorkload) -> dict:
        """Fit the cost model over the probe rungs: per-executable compile
        seconds (median) and the warm execute line ``a + b*steps``."""
        probes = self._probe_steps(workload)
        points = [(v, *self._measure_probe(v)) for v in probes]
        compile_s = float(np.median([c for _, c, _ in points]))
        xs = np.array([v for v, _, _ in points], dtype=np.float64)
        ys = np.array([w for _, _, w in points], dtype=np.float64)
        if len(xs) >= 2 and float(np.ptp(xs)) > 0:
            slope, intercept = np.polyfit(xs, ys, 1)
        else:
            slope, intercept = ys[0] / xs[0], 0.0
        slope = float(max(slope, 1e-12))
        return {"compile_s": compile_s, "exec_slope_s": slope,
                "exec_intercept_s": float(intercept),
                # lists, not tuples: meta must survive a JSON round trip
                # unchanged (profile equality backs the DB-reuse guard)
                "probes": [[int(v), float(c), float(w)]
                           for v, c, w in points]}

    # ------------------------------------------------------------------
    # Walk kernels' block sweep
    # ------------------------------------------------------------------

    def sweep_rows_per_block(self, candidates=(4, 8, 16),
                             probe_symbols: int = 4096) -> dict:
        """Block-size sweep of the walk kernels (``rows_per_block`` warps a
        block).  On the card each candidate is timed (and counts as a
        measurement); on the CPU a timing would measure the plain torch
        walk, so each candidate is structurally validated instead — plan,
        lower, run, bit-exact output — and the default stays.  A candidate
        whose output is not the input symbols raises on either device."""
        req = self._request(probe_symbols)
        from ..engine.session import DecoderSession
        timed = self.device.type == "cuda"
        results = {}
        for rpb in candidates:
            sess = DecoderSession(self.model, device=self.device,
                                  rows_per_block=rpb, layout=self.layout,
                                  policy="legacy")
            ds = sess.upload_stream(req["enc"].stream)
            out = sess.decode_batch(req["batch"], ds, req["n"]).cpu().numpy()
            if not (out == req["syms"]).all():
                raise RuntimeError(f"rows_per_block={rpb}: the walk's "
                                   "output is not the input symbols")
            entry = {"valid": True}
            if timed:
                plan = sess.prepare(req["batch"], ds, req["n"])
                warm = [self._timed(lambda: sess.execute(plan))[1]
                        for _ in range(self.repeats)]
                entry["warm_s"] = float(np.median(warm))
                self.measurements += 1
            results[rpb] = entry
        valid = {r: e for r, e in results.items() if e["valid"]}
        if timed and valid:
            best = min(valid, key=lambda r: valid[r]["warm_s"])
        else:
            best = 8 if results.get(8, {}).get("valid") else (
                next(iter(valid), None))
        return {"best": best, "timed": timed, "candidates": results}

    # ------------------------------------------------------------------
    # Tune (observe -> measure -> derive -> persist)
    # ------------------------------------------------------------------

    def tune(self, sizes, *, db: TuningDB | None = None, db_path=None,
             max_batch: int = 8, horizon: int = 100,
             force: bool = False) -> Profile:
        """Full loop for a request-size sweep.  When the database already
        holds a profile for this key whose workload signature matches,
        that profile is returned with ZERO timed measurements — the CI
        guard for the persisted-DB acceptance criterion."""
        if db is None:
            db = TuningDB.load(db_path if db_path is not None
                               else default_db_path())
        key = profile_key(self.platform, self.impl, self.layout)
        workload = self.observe(sizes)
        sig = workload.signature()
        existing = db.profiles.get(key)
        if existing is not None and existing.workload_sig == sig \
                and not force:
            return existing
        fit = self.measure(workload)
        ladder = derive_work_ladder(workload.work_sizes, fit["compile_s"],
                                    fit["exec_slope_s"], horizon=horizon)
        min_work = min(workload.work_sizes) if workload.work_sizes else 1
        item_s = (max(fit["exec_intercept_s"], 0.0)
                  + fit["exec_slope_s"] * min_work)
        micro = derive_quantized_sizes(fit["compile_s"], item_s, max_batch,
                                       horizon=horizon)
        rpb = None
        if self.impl == "cuda":
            sweep = self.sweep_rows_per_block()
            rpb = sweep["best"]
            fit["rows_per_block_sweep"] = {
                "timed": sweep["timed"],
                "candidates": {str(k): v for k, v in
                               sweep["candidates"].items()}}
        prof = Profile(key=key, work_ladder=ladder, mem_ladder=(),
                       rows_per_block=rpb, microbatch_sizes=micro,
                       workload_sig=sig, measurements=self.measurements,
                       meta=fit)
        db.put(prof)
        db.save(db.path if db.path is not None
                else (db_path if db_path is not None else default_db_path()))
        return prof

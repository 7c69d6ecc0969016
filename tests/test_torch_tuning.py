"""The port's bucket policies, autotuner and tuning database against the
JAX package's (``tests/test_tuning.py``, every case, the same assertions).

On top of the reference's assertions, each case holds the port to the
reference on the same inputs: ladders, tags and the breakpoint program's
output are equal, decodes under legacy and tuned policies equal the
reference's, a database either package writes loads in the other, and the
tuner's observed workload is the reference's.  The port's degenerate case
(resolving a launcher compiles nothing, so the fitted compile cost is close
to zero) is stated in a test of its own.

The tuner cases are as small as the reference's (``repeats=2,
max_probes=2, n_splits=4``) and run on the CPU (``device="cpu"``).  Each
test runs in a child pytest process (``test_torch_isolation.in_child``),
and torch and the port are imported inside the tests.
"""

import json

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import recoil as j_recoil
from repro.core.engine import DecoderSession as JSession
from repro.core.engine.plan import LadderBucketPolicy as JLadder
from repro.core.engine.plan import legacy_rungs as j_legacy_rungs
from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.core.tuning import Autotuner as JAutotuner
from repro.core.tuning import Profile as JProfile
from repro.core.tuning import TuningDB as JTuningDB
from repro.core.tuning import derive_quantized_sizes as j_quantized
from repro.core.tuning import derive_work_ladder as j_work_ladder
from repro.core.tuning.tuner import _breakpoint_dp as j_breakpoint_dp
from repro.core.vectorized import WalkBatch as JBatch
from repro.core.vectorized import encode_interleaved_fast as j_encode


def _model_and_syms(n=40_000, seed=0, ways=32, n_bits=11):
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)
    params = RansParams(n_bits=n_bits, ways=ways)
    return StaticModel.from_symbols(syms, 256, params), syms


def _j_model(model):
    return JModel(f=model.f, F=model.F,
                  params=JParams(n_bits=model.params.n_bits,
                                 ways=model.params.ways))


def _batch(model, syms, n_splits=8):
    from repro_torch.core import recoil
    from repro_torch.core.recoil import build_split_states
    from repro_torch.core.vectorized import (WalkBatch,
                                             encode_interleaved_fast)
    enc = encode_interleaved_fast(syms, model)
    plan = recoil.plan_splits(enc, n_splits)
    return enc, WalkBatch.from_splits(
        build_split_states(plan, enc.final_states), plan.ways)


def _j_decode(model, syms, n_splits=8, **kw):
    """The reference's jnp session decode of the same content."""
    jm = _j_model(model)
    enc = j_encode(syms, jm)
    plan = j_recoil.plan_splits(enc, n_splits)
    batch = JBatch.from_splits(
        j_recoil.build_split_states(plan, enc.final_states), plan.ways)
    sess = JSession(jm, impl="jnp", **kw)
    ds = sess.upload_stream(enc.stream)
    return np.asarray(sess.decode_batch(batch, ds, len(syms)))


def _check_policy_laws(policy, sizes):
    """The BucketPolicy contract: every executor dim relies on these."""
    prev_w = prev_m = 0
    for n in sorted(sizes):
        w, m = policy.work(n), policy.mem(n)
        assert w >= n and m >= n, (policy.tag, n)           # coverage
        assert w >= prev_w and m >= prev_m, (policy.tag, n)  # monotone
        assert policy.work(w) == w, (policy.tag, n)          # idempotent
        assert policy.mem(m) == m, (policy.tag, n)
        assert policy.work(1, floor=64) >= 64                # floor
        prev_w, prev_m = w, m


def _same_buckets(port, ref, sizes):
    for n in sizes:
        assert port.work(n) == ref.work(n), (port.tag, n)
        assert port.mem(n) == ref.mem(n), (port.tag, n)
        assert port.work(n, floor=64) == ref.work(n, floor=64)


# ----------------------------------------------------------------------
# Policy laws
# ----------------------------------------------------------------------

@in_child
def test_legacy_policy_matches_module_buckets():
    from repro.core.engine.plan import LegacyBucketPolicy as JLegacy
    from repro_torch.core.engine.plan import (LegacyBucketPolicy,
                                              pow2_bucket, work_bucket)
    pol = LegacyBucketPolicy()
    for n in list(range(1, 600)) + [1023, 1024, 1025, 99_999]:
        assert pol.work(n) == work_bucket(n)
        assert pol.mem(n) == pow2_bucket(n)
    assert pol.tag == "legacy" == JLegacy().tag
    _check_policy_laws(pol, range(1, 3000))
    _same_buckets(pol, JLegacy(), range(1, 3000))


@in_child
def test_legacy_rungs_are_the_legacy_ladder():
    from repro_torch.core.engine.plan import legacy_rungs, work_bucket
    rungs = list(legacy_rungs(1, 4096))
    assert rungs == sorted(set(rungs))                       # strictly sorted
    for n in range(1, 4097):
        assert work_bucket(n) in rungs
    for lo, hi in ((1, 4096), (3, 1500), (64, 1 << 20), (7, 7)):
        assert legacy_rungs(lo, hi) == j_legacy_rungs(lo, hi)


@pytest.mark.parametrize("ladder", [
    (1, 7, 50, 333, 2048),
    tuple(j_legacy_rungs(1, 1024)),
    (64,),                                   # everything below 64 pads up
])
@in_child
def test_ladder_policy_laws(ladder):
    from repro_torch.core.engine.plan import LadderBucketPolicy
    pol = LadderBucketPolicy(ladder)
    _check_policy_laws(pol, range(1, max(ladder) + 500))
    # In-ladder sizes are exact; above the top rung the fallback covers.
    for rung in ladder:
        assert pol.work(rung) == rung
    big = max(ladder) * 3
    assert pol.work(big) >= big
    ref = JLadder(ladder)
    assert pol.tag == ref.tag
    _same_buckets(pol, ref, range(1, max(ladder) * 4))


@in_child
def test_ladder_tag_digest_distinguishes_ladders():
    from repro_torch.core.engine.plan import LadderBucketPolicy
    a = LadderBucketPolicy((1, 2, 4))
    b = LadderBucketPolicy((1, 2, 8))
    assert a.tag != b.tag and a.tag.startswith("ladder:")
    assert a.tag == JLadder((1, 2, 4)).tag and b.tag == JLadder((1, 2, 8)).tag
    c = LadderBucketPolicy((1, 2, 4), (16, 64))
    assert c.tag == JLadder((1, 2, 4), (16, 64)).tag != a.tag


# ----------------------------------------------------------------------
# Breakpoint DP + derivations
# ----------------------------------------------------------------------

@in_child
def test_breakpoint_dp_extremes():
    from repro_torch.core.tuning.tuner import _breakpoint_dp
    vals, counts = [10, 20, 40, 80], [5, 5, 5, 5]
    # Compile dwarfs padding -> one bucket at the max.
    assert _breakpoint_dp(vals, counts, 1e9, 1e-9) == [80]
    # Padding dwarfs compile -> every value its own bucket.
    assert _breakpoint_dp(vals, counts, 1e-9, 1e9) == vals
    assert _breakpoint_dp([], [], 1.0, 1.0) == []
    for c, u in ((1e9, 1e-9), (1e-9, 1e9), (3.0, 0.05), (0.0, 1.0)):
        assert _breakpoint_dp(vals, counts, c, u) == \
            j_breakpoint_dp(vals, counts, c, u)


@in_child
def test_breakpoint_dp_is_optimal_on_small_case():
    from repro_torch.core.tuning.tuner import _breakpoint_dp
    vals, counts = [10, 12, 100], [1, 1, 1]
    # cost(partition) = #buckets*C + unit*sum(top*hits); C=5, unit=1:
    #   {10,12,100}: 3*5 + 122 = 137 ; {[10,12],[100]}: 2*5 + 124 = 134
    #   {[10,12,100]}: 1*5 + 300 = 305
    assert _breakpoint_dp(vals, counts, 5.0, 1.0) == [12, 100]
    assert j_breakpoint_dp(vals, counts, 5.0, 1.0) == [12, 100]


@in_child
def test_derived_ladder_satisfies_laws_and_keeps_legacy_floor():
    from repro_torch.core.engine.plan import LadderBucketPolicy, legacy_rungs
    from repro_torch.core.tuning import derive_work_ladder
    sizes = {83: 4, 107: 2, 131: 2, 1500: 1}
    ladder = derive_work_ladder(sizes, 0.3, 3e-5, horizon=10_000)
    pol = LadderBucketPolicy(ladder)
    _check_policy_laws(pol, range(1, 2000))
    for v in sizes:                       # high horizon: exact rungs kept
        assert pol.work(v) == v
    for r in legacy_rungs(1, 1500):       # unobserved dims keep <=1.5x bound
        assert r in ladder
    for c, s, h in ((0.3, 3e-5, 10_000), (0.3, 3e-5, 1), (50.0, 1e-6, 100)):
        assert derive_work_ladder(sizes, c, s, horizon=h) == \
            j_work_ladder(sizes, c, s, horizon=h)
    assert derive_work_ladder({}, 1.0, 1.0) == j_work_ladder({}, 1.0, 1.0)


@in_child
def test_derive_quantized_sizes_contains_max_batch():
    from repro_torch.core.tuning import derive_quantized_sizes
    for C, item in [(0.3, 1e-3), (0.0, 1.0), (10.0, 1e-6)]:
        sizes = derive_quantized_sizes(C, item, 8)
        assert sizes == tuple(sorted(set(sizes)))
        assert sizes[-1] == 8 and all(1 <= s <= 8 for s in sizes)
        assert sizes == j_quantized(C, item, 8)


# ----------------------------------------------------------------------
# No aliasing between policies
# ----------------------------------------------------------------------

@in_child
def test_legacy_and_tuned_plans_never_alias_and_stay_bit_exact():
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.engine.plan import legacy_rungs
    from repro_torch.core.tuning import Profile
    model, syms = _model_and_syms()
    enc, batch = _batch(model, syms)
    # A tuned ladder that buckets IDENTICALLY to legacy — the adversarial
    # aliasing case: only the tag keeps the launchers apart.
    twin = Profile(key="cpu:torch:auto",
                   work_ladder=tuple(legacy_rungs(1, 1 << 20)))
    sessions = {
        "legacy": DecoderSession(model, device="cpu"),
        "tuned": DecoderSession(model, device="cpu", policy=twin),
    }
    plans, outs = {}, {}
    for name, sess in sessions.items():
        ds = sess.upload_stream(enc.stream)
        plans[name] = sess.prepare(batch, ds, len(syms))
        outs[name] = sess.execute(plans[name]).numpy()
        assert sess.stats.compiles == 1
    assert (outs["legacy"] == syms).all()
    assert (outs["tuned"] == syms).all()
    assert plans["legacy"].key != plans["tuned"].key
    assert "legacy" in plans["legacy"].key
    assert any(isinstance(p, str) and p.startswith("tuned:")
               for p in plans["tuned"].key)
    # Same buckets, different launchers — aliasing would have reused.
    assert plans["legacy"].statics == plans["tuned"].statics
    diff = [i for i, (a, b) in enumerate(zip(plans["legacy"].key,
                                             plans["tuned"].key)) if a != b]
    assert [plans["legacy"].key[i] for i in diff] == ["legacy"]
    ref = _j_decode(model, syms)
    np.testing.assert_array_equal(outs["legacy"], ref)
    jtwin = JProfile(key="cpu:jnp:auto",
                     work_ladder=tuple(j_legacy_rungs(1, 1 << 20)))
    np.testing.assert_array_equal(outs["tuned"],
                                  _j_decode(model, syms, policy=jtwin))


@in_child
def test_tuned_profile_decode_bit_exact_with_sparse_ladder():
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.tuning import Profile
    model, syms = _model_and_syms(n=20_000, seed=3)
    enc, batch = _batch(model, syms)
    prof = Profile(key="cpu:torch:auto",
                   work_ladder=(1, 3, 9, 100, 4096, 1 << 16))
    sess = DecoderSession(model, device="cpu", policy=prof)
    assert sess.tuning_profile is prof
    ds = sess.upload_stream(enc.stream)
    out = sess.decode_batch(batch, ds, len(syms)).numpy()
    assert (out == syms).all()
    jprof = JProfile(key="cpu:jnp:auto",
                     work_ladder=(1, 3, 9, 100, 4096, 1 << 16))
    np.testing.assert_array_equal(out, _j_decode(model, syms, policy=jprof))


# ----------------------------------------------------------------------
# Tuning DB
# ----------------------------------------------------------------------

def _profile(key="cpu:torch:auto"):
    from repro_torch.core.tuning import Profile
    return Profile(key=key, work_ladder=(1, 2, 4, 96), mem_ladder=(),
                   rows_per_block=8, microbatch_sizes=(1, 4, 8),
                   workload_sig="abc123", measurements=3,
                   meta={"compile_s": 0.25})


@in_child
def test_tuning_db_round_trip(tmp_path):
    from repro_torch.core.tuning import TuningDB
    path = tmp_path / "tuning.json"
    db = TuningDB()
    db.put(_profile())
    db.put(_profile("cpu:*:*"))
    db.save(path)
    back = TuningDB.load(path)
    assert back.profiles == db.profiles           # frozen dataclass equality
    assert back.get("cpu:torch:auto") == _profile()
    # Wildcard fallback chain.
    assert back.get("cpu:cuda:symbol") == _profile("cpu:*:*")
    assert back.get("cuda:torch:auto") is None


@in_child
def test_tuning_db_written_by_either_package_loads_in_the_other(tmp_path):
    from repro_torch.core.tuning import Profile, TuningDB
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    db = TuningDB()
    db.put(_profile())
    db.put(_profile("cuda:cuda:auto"))
    db.save(port_path)
    jback = JTuningDB.load(port_path)
    assert sorted(jback.profiles) == ["cpu:torch:auto", "cuda:cuda:auto"]
    for key, prof in db.profiles.items():
        assert jback.profiles[key].to_dict() == prof.to_dict()
    jdb = JTuningDB()
    jdb.put(JProfile(key="cpu:jnp:auto", work_ladder=(1, 5, 40),
                     rows_per_block=16, microbatch_sizes=(2, 6),
                     workload_sig="sig", measurements=4,
                     meta={"exec_slope_s": 1e-6, "probes": [[64, 0.1, 0.2]]}))
    jdb.save(ref_path)
    back = TuningDB.load(ref_path)
    assert back.get("cpu:jnp:auto") == Profile.from_dict(
        jdb.profiles["cpu:jnp:auto"].to_dict())
    assert back.get("cpu:jnp:auto").policy().tag == \
        jdb.get("cpu:jnp:auto").policy().tag
    # The same profiles saved by both packages give the same bytes.
    jdb2 = JTuningDB()
    for key, prof in db.profiles.items():
        jdb2.put(JProfile.from_dict(prof.to_dict()))
    jdb2.save(tmp_path / "ref2.json")
    assert (tmp_path / "ref2.json").read_bytes() == port_path.read_bytes()


@in_child
def test_tuning_db_schema_version_is_loud(tmp_path):
    from repro_torch.core.tuning import TuningDB, TuningSchemaError
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"schema": 999, "profiles": {}}))
    with pytest.raises(TuningSchemaError):
        TuningDB.load(path)
    missing = TuningDB.load(tmp_path / "nope.json")
    assert missing.profiles == {}                 # missing file: empty DB


@in_child
def test_builtin_default_profile_loads_and_obeys_laws():
    from repro.core.tuning import builtin_db_path as j_builtin
    from repro_torch.core.tuning import (TuningDB, builtin_db_path,
                                         profile_key)
    db = TuningDB.load(builtin_db_path())
    prof = db.get(profile_key("cpu", "torch", "auto"))
    assert prof is not None and prof.measurements == 0
    assert prof.key == "cpu:*:*"                  # the CPU wildcard row
    _check_policy_laws(prof.policy(), range(1, 5000))
    ref = JTuningDB.load(j_builtin()).get("cpu:torch:auto")
    assert prof.to_dict() == ref.to_dict()
    assert prof.policy().tag == ref.policy().tag
    assert db.get(profile_key("cuda", "cuda", "auto")) is None


@in_child
def test_resolve_policy_modes(tmp_path, monkeypatch):
    from repro_torch.core.engine.plan import (LEGACY_POLICY,
                                              LadderBucketPolicy)
    from repro_torch.core.tuning import TuningDB, resolve_policy
    monkeypatch.delenv("REPRO_TUNING_DB", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    pol, prof = resolve_policy(None, impl="torch", layout="auto")
    assert pol is LEGACY_POLICY and prof is None   # default stays legacy
    pol, prof = resolve_policy("legacy", impl="torch", layout="auto")
    assert pol is LEGACY_POLICY
    ladder = LadderBucketPolicy((1, 8))
    assert resolve_policy(ladder, impl="torch", layout="auto")[0] is ladder
    p = _profile()
    pol, prof = resolve_policy(p, impl="torch", layout="auto")
    assert prof is p and pol.tag.startswith("tuned:cpu:torch:auto")
    with pytest.raises(ValueError):
        resolve_policy("warp-speed", impl="torch", layout="auto")
    # Env DB present: None now opts into the tuned stack.
    db = TuningDB()
    db.put(_profile())
    db.save(tmp_path / "env.json")
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "env.json"))
    pol, prof = resolve_policy(None, impl="torch", layout="auto")
    assert prof == _profile() and pol.tag.startswith("tuned:")
    # The card's key is its own: the CPU profile never reaches it.
    pol, prof = resolve_policy(None, impl="cuda", layout="auto")
    assert prof is None and pol is LEGACY_POLICY
    # Tuned with no profile anywhere: quiet legacy fallback.
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "empty.json"))
    pol, prof = resolve_policy("tuned", impl="torch", layout="nosuch-layout")
    assert prof is None or prof.key.endswith(":*")
    # An env DB that fails to load is loud, never a quiet default.
    (tmp_path / "bad.json").write_text(json.dumps({"schema": 0}))
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "bad.json"))
    with pytest.raises(ValueError):
        resolve_policy(None, impl="torch", layout="auto")


# ----------------------------------------------------------------------
# Autotuner: measure once, reuse forever
# ----------------------------------------------------------------------

@in_child
def test_autotuner_measures_then_reuses_db(tmp_path, monkeypatch):
    from repro_torch.core.tuning import Autotuner
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    db_path = tmp_path / "tuning.json"
    sizes = [6_000, 9_000]
    kw = dict(device="cpu", repeats=2, max_probes=2, n_splits=4)
    t1 = Autotuner(**kw)
    prof = t1.tune(sizes, db_path=db_path, max_batch=4)
    assert t1.measurements > 0
    assert prof.key == "cpu:torch:auto"
    assert prof.workload_sig and prof.work_ladder
    _check_policy_laws(prof.policy(), range(1, 2000))
    assert prof.microbatch_sizes[-1] == 4
    # Second invocation, same workload: the DB answers, zero probes.
    t2 = Autotuner(**kw)
    prof2 = t2.tune(sizes, db_path=db_path, max_batch=4)
    assert t2.measurements == 0
    assert prof2 == prof
    # force=True re-measures even on a signature hit.
    t3 = Autotuner(**kw)
    t3.tune(sizes, db_path=db_path, max_batch=4, force=True)
    assert t3.measurements > 0
    # A different workload invalidates the signature.
    t4 = Autotuner(**kw)
    t4.tune([6_000, 12_000], db_path=db_path, max_batch=4)
    assert t4.measurements > 0
    assert not (tmp_path / "cache").exists()      # never the user cache


@in_child
def test_autotuner_observe_is_compile_free():
    from repro_torch.core.tuning import Autotuner
    from repro_torch.kernels.rans_decode import rans_decode as rd
    rd.reset_counts()
    t = Autotuner(device="cpu", repeats=2, n_splits=4)
    workload = t.observe([4_000, 8_000])
    assert t.measurements == 0
    assert workload.work_sizes and workload.mem_sizes
    assert workload.signature() == t.observe([4_000, 8_000]).signature()
    assert workload.signature() != t.observe([4_000]).signature()
    # No launcher resolved, nothing launched or walked.
    for fn in (rd.walk_decode_pointer, rd.walk_decode_symbol):
        assert (fn.launches, fn.plain_calls) == (0, 0)
    # The same traffic makes the reference's bucket requests.
    ref = JAutotuner(impl="jnp", repeats=2, n_splits=4).observe([4_000, 8_000])
    assert workload.signature() == ref.signature()
    assert workload.work_sizes == ref.work_sizes
    assert workload.mem_sizes == ref.mem_sizes


@in_child
def test_autotuner_rows_per_block_sweep_is_structural_on_the_cpu():
    from repro_torch.core.tuning import Autotuner
    t = Autotuner(device="cpu", repeats=2, n_splits=4)
    sweep = t.sweep_rows_per_block()
    assert sweep["timed"] is False and sweep["best"] == 8
    assert sweep["candidates"] == {r: {"valid": True} for r in (4, 8, 16)}
    assert t.measurements == 0
    with pytest.raises(ValueError):
        t.sweep_rows_per_block(candidates=(3,))
    with pytest.raises(ValueError, match="impl"):
        Autotuner(device="cpu", impl="cuda")


@in_child
def test_autotuner_sweep_raises_on_a_wrong_block(monkeypatch):
    """A candidate whose output is not the input symbols raises: the sweep
    never marks it invalid and moves on to another block."""
    from repro_torch.core.engine.session import DecoderSession
    from repro_torch.core.tuning import Autotuner
    decode = DecoderSession.decode_batch

    def corrupt(self, *args, **kw):
        out = decode(self, *args, **kw)
        return out + 1 if self.executor.rows_per_block == 16 else out

    monkeypatch.setattr(DecoderSession, "decode_batch", corrupt)
    t = Autotuner(device="cpu", repeats=2, n_splits=4)
    with pytest.raises(RuntimeError, match="rows_per_block=16"):
        t.sweep_rows_per_block()
    assert t.measurements == 0


@in_child
def test_tuner_without_a_card_raises(monkeypatch):
    """``Autotuner()`` defaults to the card; with none visible it raises
    instead of tuning the CPU under the card's key."""
    import torch
    from repro_torch.core.tuning import Autotuner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Autotuner()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Autotuner(device="cuda", impl="cuda")


@in_child
def test_degenerate_case_resolves_no_compiler():
    """The port's own case, beside the reference's: a launcher is a
    ``functools.partial`` (resolving it compiles nothing), and the walk runs
    its splits' real steps whatever the steps bucket, so the fitted compile
    cost is close to zero.  With no compile cost, the breakpoint program
    keeps every observed work value as its own rung, in both packages."""
    import functools
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.engine.plan import LadderBucketPolicy
    from repro_torch.core.tuning import Autotuner, derive_work_ladder
    model, syms = _model_and_syms(n=12_000, seed=9)
    enc, batch = _batch(model, syms)
    plans = []
    for ladder in ((1, 1 << 20), (batch.n_steps, 1 << 20)):
        sess = DecoderSession(model, device="cpu",
                              policy=LadderBucketPolicy(ladder))
        plan = sess.prepare(batch, enc.stream, len(syms))
        assert isinstance(sess.executor.lower(plan), functools.partial)
        assert (sess.execute(plan).numpy() == syms).all()
        plans.append(plan)
    assert plans[0].key != plans[1].key
    assert plans[0].n_steps == plans[1].n_steps == batch.n_steps
    workload = Autotuner(device="cpu", n_splits=4).observe([4_000, 8_000])
    ladder = derive_work_ladder(workload.work_sizes, 0.0, 1e-9)
    assert set(workload.work_sizes) <= set(ladder)
    assert ladder == j_work_ladder(workload.work_sizes, 0.0, 1e-9)


# ----------------------------------------------------------------------
# EncoderSession resumable-tail LRU
# ----------------------------------------------------------------------

@in_child
def test_encoder_resume_lru_bounds_and_counts_evictions():
    from repro_torch.core.encode import EncoderSession
    model, syms = _model_and_syms(n=12_000, seed=5)
    sess = EncoderSession(model, device="cpu", resume_capacity=2)
    for name in ("a", "b", "c"):
        sess.ingest(syms[:4096], 4, name=name)
    assert sess.stats.resume_evictions == 1       # "a" fell off
    assert list(sess._resume) == ["b", "c"]
    with pytest.raises(KeyError):
        sess.extend("a", syms[4096:4200])
    # extend touches recency: "b" becomes most recent, next insert evicts c.
    sess.extend("b", syms[4096:4200])
    sess.ingest(syms[:4096], 4, name="d")
    assert list(sess._resume) == ["b", "d"]
    assert sess.stats.resume_evictions == 2
    with pytest.raises(ValueError):
        EncoderSession(model, device="cpu", resume_capacity=0)


# ----------------------------------------------------------------------
# Broker quantization from the tuned profile; the tuned service's encoder
# ----------------------------------------------------------------------

@in_child
def test_broker_derives_quantized_sizes_from_profile():
    from repro_torch.core.engine.plan import legacy_rungs
    from repro_torch.core.tuning import Profile
    from repro_torch.runtime.serve import DecodeService
    model, syms = _model_and_syms(n=8_000, seed=7)
    prof = Profile(key="cpu:torch:auto",
                   work_ladder=tuple(legacy_rungs(1, 1 << 16)),
                   microbatch_sizes=(1, 3, 6))
    svc = DecodeService(model, device="cpu", policy=prof)
    assert svc.tuning_profile is prof
    svc.ingest_batch({"c0": syms}, 4)
    with svc.start_pipeline() as broker:
        assert broker.controller.cfg.sizes() == (1, 3, 6)
        assert broker.controller.cfg.max_batch == 6
        out = broker.submit("c0", 4).result(timeout=30)
        assert (out.numpy() == syms).all()
    # An untuned service keeps the default pow2 quantization.
    svc2 = DecodeService(model, device="cpu")
    assert svc2.tuning_profile is None
    svc2.ingest_batch({"c0": syms}, 4)
    with svc2.start_pipeline() as broker2:
        assert broker2.controller.cfg.sizes() == (1, 2, 4, 8)


@in_child
def test_tuned_service_encoder_resolves_its_own_key(tmp_path, monkeypatch):
    from repro.runtime.serve import DecodeService as JService
    from repro_torch.core.tuning import Profile, TuningDB
    from repro_torch.runtime.serve import DecodeService
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    db = TuningDB()
    for key in ("cpu:torch:encode", "cpu:jnp:encode"):
        db.put(Profile(key=key, work_ladder=(1, 2, 4, 7, 300)))
    db.save(tmp_path / "db.json")
    model, syms = _model_and_syms(n=6_000, seed=11)
    prof = Profile(key="cpu:torch:auto", work_ladder=(1, 2, 3, 4096))
    jprof = JProfile(key="cpu:jnp:auto", work_ladder=(1, 2, 3, 4096))
    jm = _j_model(model)
    # Untuned services keep the encoder on the legacy ladder.
    svc = DecodeService(model, device="cpu")
    svc.ingest("a", syms, 4)
    assert svc._encode_session().tuning_profile is None
    assert svc._encode_session().policy.tag == "legacy"
    monkeypatch.setenv("REPRO_TUNING_DB", str(tmp_path / "db.json"))
    svc = DecodeService(model, device="cpu", policy=prof)
    jsvc = JService(jm, impl="jnp", policy=jprof)
    for s in (svc, jsvc):
        s.ingest("a", syms, 4)
    enc, jenc = svc._encode_session(), jsvc._encode_session()
    assert svc.tuning_profile is prof and jsvc.tuning_profile is jprof
    assert enc.tuning_profile.key == "cpu:torch:encode"
    assert jenc.tuning_profile.key == "cpu:jnp:encode"
    assert enc.policy.tag.startswith("tuned:cpu:torch:encode:")
    assert enc.policy.tag.split(":")[-1] == jenc.policy.tag.split(":")[-1]
    out = svc.decode("a", 4).numpy()
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(out, np.asarray(jsvc.decode("a", 4)))

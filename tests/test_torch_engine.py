"""The port's DecoderSession on the CPU against the JAX package's
``DecoderSession(impl="jnp")``.

Both sessions decode the same content (seeded numpy symbols, encoded by the
reference) under both stream layouts and both slot-table layouts, over the
reference's conformance cases and the frozen golden vectors.  Outputs,
engine counters and the fused batch fields must be equal.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and torch and the port are imported inside the tests, so the test worker
itself never loads torch beside jaxlib.
"""

import glob
import os

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import container as j_container
from repro.core import recoil as j_recoil
from repro.core.engine import DecoderSession as JSession
from repro.core.engine import concat_walk_batches as j_concat
from repro.core.engine import with_symbol_layout as j_with_symbol_layout
from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.core.vectorized import WalkBatch as JBatch
from repro.core.vectorized import encode_interleaved_fast as j_encode

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NAMES = sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(GOLDEN, "*.bin")))

# (seed, n, ways, n_splits, thin) — tests/test_conformance.py's matrix.
DETERMINISTIC_CASES = [
    (0, 3_000, 32, 16, None),
    (1, 2_047, 32, 7, 3),
    (2, 4_096, 32, 1, None),
    (3, 2_500, 64, 24, 5),
    (4, 1_537, 16, 4, None),
    (5, 3_333, 32, 12, 1),
]


def _model(ways):
    rng = np.random.default_rng(1234 + ways)
    ref = np.concatenate([
        np.minimum(rng.exponential(40.0, size=50_000).astype(np.int64), 255),
        np.arange(256)])
    return JModel.from_symbols(ref, 256, JParams(n_bits=11, ways=ways))


def _port_model(jm):
    from repro_torch.core import convert
    return convert.model_from_arrays(jm.f, jm.F, jm.params.n_bits,
                                     jm.params.ways)


def _port_plan(jp):
    from repro_torch.core import convert
    return convert.plan_from_arrays(**convert.plan_arrays(jp))


def _decode_both(jm, plan, stream, final_states, k_of_word, n, layout,
                 packed):
    import torch
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    js = JSession(jm, impl="jnp", layout=layout, packed_lut=packed)
    ts = DecoderSession(_port_model(jm), device="cpu", layout=layout,
                        packed_lut=packed)
    jds = js.upload_stream(stream)
    tds = ts.upload_stream(stream)
    if layout == "symbol":
        jds = j_with_symbol_layout(jds, k_of_word, n)
        tds = with_symbol_layout(tds, k_of_word, n)
    j_out = np.asarray(js.decode(plan, jds, final_states))
    t_out = ts.decode(_port_plan(plan), tds, final_states)
    assert t_out.dtype == torch.int32 and t_out.device.type == "cpu"
    return j_out, t_out.numpy()


@pytest.mark.parametrize("layout", ["pointer", "symbol"])
@pytest.mark.parametrize("seed,n,ways,n_splits,thin", DETERMINISTIC_CASES)
@in_child
def test_session_matches_reference(seed, n, ways, n_splits, thin, layout):
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)
    jm = _model(ways)
    enc = j_encode(syms, jm)
    plan = j_recoil.plan_splits(enc, n_splits)
    if thin is not None:
        plan = j_recoil.combine_plan(plan, thin)
    for packed in (True, False):
        j_out, t_out = _decode_both(jm, plan, enc.stream, enc.final_states,
                                    enc.k_of_word, n, layout, packed)
        np.testing.assert_array_equal(t_out, j_out)
        np.testing.assert_array_equal(t_out, syms)


@pytest.mark.parametrize("name", GOLDEN_NAMES)
@in_child
def test_golden_vectors_decode_like_reference(name):
    import torch
    from repro_torch.core import container
    from repro_torch.core.engine import derive_symbol_layout, pow2_bucket
    from repro_torch.core.rans import RansParams
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as f:
        buf = f.read()
    npz = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    params = RansParams(n_bits=int(npz["n_bits"]), ways=int(npz["ways"]))
    parsed = container.parse(buf, params)
    jparsed = j_container.parse(buf, JParams(n_bits=params.n_bits,
                                             ways=params.ways))
    syms = npz["symbols"]
    n = len(syms)
    for layout in ("pointer", "symbol"):
        j_out, t_out = _decode_both(jparsed.model, jparsed.plan,
                                    parsed.stream, parsed.final_states,
                                    npz["k_of_word"], n, layout, None)
        np.testing.assert_array_equal(t_out, j_out)
        np.testing.assert_array_equal(t_out, syms)
    # The device derivation of the permutation equals the frozen one.
    if "by_symbol" in npz:
        bucket = pow2_bucket(len(parsed.stream), 1024)
        words = torch.zeros(bucket, dtype=torch.int32)
        words[:len(parsed.stream)] = torch.from_numpy(
            parsed.stream.astype(np.int32))
        kpad = np.full(bucket, np.iinfo(np.int32).max, np.int32)
        kpad[:len(parsed.stream)] = npz["k_of_word"].astype(np.int32)
        dev = derive_symbol_layout(words, torch.from_numpy(kpad),
                                   sym_bucket=pow2_bucket(n, 1024)).numpy()
        np.testing.assert_array_equal(dev[:n], npz["by_symbol"])
        assert not dev[n:].any()


@in_child
def test_engine_stats_match_reference():
    """Two request sizes that share every bucket: one launcher resolved,
    then a cache hit — the same counts as the reference's compiles."""
    from repro_torch.core.engine import DecoderSession
    jm = _model(32)
    js = JSession(jm, impl="jnp")
    ts = DecoderSession(_port_model(jm), device="cpu")
    for seed, n in ((21, 3_000), (22, 2_900)):
        rng = np.random.default_rng(seed)
        syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64),
                          255)
        enc = j_encode(syms, jm)
        plan = j_recoil.plan_splits(enc, 8)
        np.testing.assert_array_equal(
            ts.decode(_port_plan(plan), enc.stream, enc.final_states).numpy(),
            np.asarray(js.decode(plan, enc.stream, enc.final_states)))
    _stats_equal(ts, js)
    assert (ts.stats.compiles, ts.stats.cache_hits) == (1, 1)
    assert ts.executables == 1


def _stats_equal(ts, js):
    """The port's engine counters equal the reference's; the one it adds,
    which counts walks on the card's stream pool, reads 0 on the CPU."""
    t, j = ts.stats.snapshot(), js.stats.snapshot()
    assert {k: t[k] for k in j} == j
    assert set(t) - set(j) == {"overlapped_launches"}
    assert t["overlapped_launches"] == 0


@in_child
def test_concat_walk_batches_fields_equal():
    from repro_torch.core import convert
    from repro_torch.core.engine import concat_walk_batches
    jm = _model(32)
    batches = []
    for seed, n, splits in ((31, 2_000, 5), (32, 3_100, 9), (33, 1_200, 1)):
        rng = np.random.default_rng(seed)
        syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64),
                          255)
        enc = j_encode(syms, jm)
        plan = j_recoil.plan_splits(enc, splits)
        batches.append(JBatch.from_splits(
            j_recoil.build_split_states(plan, enc.final_states), 32))
    offs = dict(sym_offsets=[0, 2_000, 5_100], word_offsets=[0, 1024, 3072],
                perm_offsets=[0, 2048, 6144])
    jf = j_concat(batches, **offs)
    tf = concat_walk_batches(
        [convert.batch_from_arrays(convert.batch_arrays(b), b.n_steps, b.ways)
         for b in batches], **offs)
    for name in convert.BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name))
        assert getattr(tf, name).dtype == getattr(jf, name).dtype, name
    assert (tf.n_steps, tf.ways) == (jf.n_steps, jf.ways)


@in_child
def test_session_device_and_impl_rules():
    import torch
    from repro_torch.core.engine import DecoderSession
    jm = _model(32)
    tm = _port_model(jm)
    sess = DecoderSession(tm, device="cpu")
    assert sess.impl == "torch"
    with pytest.raises(AttributeError):
        sess.impl = "cuda"                    # the device fixes it
    assert DecoderSession(tm, device="cpu", impl="torch").impl == "torch"
    with pytest.raises(ValueError, match="fixes the impl"):
        DecoderSession(tm, device="cpu", impl="cuda")
    if torch.cuda.is_available():
        assert DecoderSession(tm).impl == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecoderSession(tm)


@pytest.mark.parametrize("n_words", [3_000, 70_000])
@in_child
def test_with_symbol_layout_is_int16_at_any_word_count(n_words):
    """Every permutation entry is a 16-bit word, so the port stores it as
    int16 at any stream length, where the reference widens to u32 at 2^16
    words; read unsigned, it equals the reference's host oracle and the
    reference's own ``with_symbol_layout``.  The stream itself is int16 on
    the device too."""
    import torch
    from repro.core.vectorized import words_by_symbol_host as j_wbs
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    rng = np.random.default_rng(n_words)
    n_symbols = 2 * n_words + 17
    words = rng.integers(0, 1 << 16, size=n_words).astype(np.uint16)
    k_of_word = np.sort(rng.choice(n_symbols, size=n_words, replace=False))
    jm = _model(32)
    ts = DecoderSession(_port_model(jm), device="cpu")
    ds = ts.upload_stream(words)
    assert ds.words.dtype == torch.int16
    np.testing.assert_array_equal(
        ds.words[:n_words].numpy().view(np.uint16), words)
    ds = with_symbol_layout(ds, k_of_word, n_symbols)
    assert ds.by_symbol.dtype == torch.int16
    got = ds.by_symbol.numpy().view(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(got[:n_symbols],
                                  j_wbs(words, k_of_word, n_symbols))
    jds = j_with_symbol_layout(
        JSession(jm, impl="jnp").upload_stream(words), k_of_word, n_symbols)
    want = np.asarray(jds.by_symbol).astype(np.uint32) & 0xFFFF
    assert ds.sym_bucket == jds.sym_bucket
    np.testing.assert_array_equal(got, want)


@in_child
def test_coverage_flag():
    """``DecodePlan.covered`` is true when the real rows' kept windows tile
    the output, and then the plain output holds no -1; a plan with a row
    removed, and a fused batch with gaps between its windows, are not
    covered."""
    from repro_torch.core import recoil
    from repro_torch.core.engine import (DecoderSession, concat_walk_batches,
                                         kept_windows_tile)
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    jm = _model(32)
    tm = _port_model(jm)
    rng = np.random.default_rng(41)
    syms = np.minimum(rng.exponential(40.0, size=6_000).astype(np.int64), 255)
    enc = encode_interleaved_fast(syms, tm)
    full = recoil.plan_splits(enc, 40)
    ts = DecoderSession(tm, device="cpu")
    ds = ts.upload_stream(enc.stream)
    batches = {}
    for threads in (1, 3, 8, 16, 40):
        rp = recoil.combine_plan(full, threads)
        batch = WalkBatch.from_splits(
            recoil.build_split_states(rp, enc.final_states), 32)
        plan = ts.prepare(batch, ds, rp.n_symbols)
        assert plan.covered and plan.args[4].shape == batch.k.shape
        out = ts.execute(plan).numpy()
        assert (out >= 0).all()
        np.testing.assert_array_equal(out, syms)
        batches[threads] = batch
    b = batches[16]
    fields = ("k", "y", "x0", "q0", "g_hi", "start", "stop", "keep_lo",
              "keep_hi", "out_base")
    for drop in (0, 7, b.k.shape[0] - 1):
        keep = np.arange(b.k.shape[0]) != drop
        cut = WalkBatch(**{f: getattr(b, f)[keep] for f in fields},
                        n_steps=b.n_steps, ways=32)
        assert not kept_windows_tile(cut, len(syms))
        plan = ts.prepare(cut, ds, len(syms))
        assert not plan.covered
        assert (ts.execute(plan).numpy() == -1).any()
    n = len(syms)
    assert kept_windows_tile(
        concat_walk_batches([b, batches[3]], [0, n]), 2 * n)
    gapped = concat_walk_batches([b, batches[3]], [0, n + 100])
    assert not kept_windows_tile(gapped, 2 * n + 100)
    plan = ts.prepare(gapped, ds, 2 * n + 100)
    assert not plan.covered
    out = ts.execute(plan).numpy()
    assert (out[n:n + 100] == -1).all()
    np.testing.assert_array_equal(out[n + 100:], syms)


@in_child
def test_plans_of_one_key_decode_their_own_sizes():
    """Two requests that share a plan key, and so one launcher bound to the
    key's bucketed sizes, but differ in n_symbols: each output has its own
    length and symbols, and the counters equal the reference's."""
    from repro_torch.core.engine import DecoderSession
    jm = _model(32)
    js = JSession(jm, impl="jnp")
    ts = DecoderSession(_port_model(jm), device="cpu")
    from repro_torch.core import convert
    plans = []
    for seed, n in ((21, 3_000), (22, 2_900)):
        rng = np.random.default_rng(seed)
        syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64),
                          255)
        enc = j_encode(syms, jm)
        rp = j_recoil.plan_splits(enc, 8)
        jb = JBatch.from_splits(
            j_recoil.build_split_states(rp, enc.final_states), 32)
        tb = convert.batch_from_arrays(convert.batch_arrays(jb), jb.n_steps,
                                       jb.ways)
        plan = ts.prepare(tb, enc.stream, n)
        out = ts.execute(plan).numpy()
        assert out.shape == (n,)
        np.testing.assert_array_equal(out, syms)
        np.testing.assert_array_equal(
            out, np.asarray(js.decode(rp, enc.stream, enc.final_states)))
        plans.append(plan)
    assert plans[0].key == plans[1].key
    assert plans[0].statics == plans[1].statics
    _stats_equal(ts, js)
    assert (ts.stats.compiles, ts.stats.cache_hits) == (1, 1)


@pytest.mark.parametrize("path", ["execute", "decode", "decode_chunks",
                                  "group"])
@in_child
def test_cpu_path_makes_no_stream_and_records_no_event(path, monkeypatch):
    """The stream pool is the card's alone: on the CPU no path through the
    engine makes a stream or records an event, a plan carries no readiness
    event, and both stats objects count no walk on the pool."""
    import torch
    from repro_torch.runtime.serve import DecodeService

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA stream or event on the CPU path")

    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    rng = np.random.default_rng(31)
    syms = {nm: np.minimum(rng.exponential(40.0, size=n).astype(np.int64),
                           255) for nm, n in (("a", 6_000), ("b", 4_500))}
    svc = DecodeService(_port_model(_model(32)), device="cpu")
    for nm, s in syms.items():
        svc.ingest(nm, s, 16)
    if path == "execute":
        plan = svc.prepare_request("a", 8)
        assert plan.ready is None
        outs = [(svc.session.execute(plan), syms["a"])]
    elif path == "decode":
        outs = [(svc.decode(nm, t), syms[nm]) for nm in syms for t in (4, 16)]
    elif path == "decode_chunks":
        outs = [(torch.cat(svc.decode_chunks("a", 16, 3)), syms["a"])]
    else:
        tickets = [(svc.submit(nm, 8), syms[nm]) for nm in syms]
        svc.flush()
        outs = [(t.result(), want) for t, want in tickets]
        assert svc.stats.fused_dispatches == 1
    for out, want in outs:
        np.testing.assert_array_equal(out.numpy(), want)
    assert svc.session.executor.streams == ()
    engine, service = svc.session.stats.snapshot(), svc.stats.snapshot()
    assert engine["decodes"] == service["decodes"] > 0
    for snap in (engine, service):
        assert snap["overlapped_launches"] == 0


@pytest.mark.parametrize("layout", ["pointer", "symbol"])
@in_child
def test_walk_runs_its_real_steps_not_the_bucket(layout, monkeypatch):
    """The plan key carries the policy's steps bucket, as the reference's
    does, but the launch walks the request's real step count: at a step
    count just above a rung (bucketed to the next rung) the plain walk runs
    exactly the steps the splits need, and the output equals the
    reference's and the symbols."""
    from repro.core.engine.plan import LadderBucketPolicy as JLadder
    from repro_torch.core import convert
    from repro_torch.core.engine import (DecoderSession, LadderBucketPolicy,
                                         with_symbol_layout)
    from repro_torch.kernels.rans_decode import rans_decode as rd
    rng = np.random.default_rng(31)
    n = 7_001
    syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)
    jm = _model(32)
    enc = j_encode(syms, jm)
    rp = j_recoil.plan_splits(enc, 6)
    jb = JBatch.from_splits(j_recoil.build_split_states(rp, enc.final_states),
                            32)
    tb = convert.batch_from_arrays(convert.batch_arrays(jb), jb.n_steps,
                                   jb.ways)
    steps = jb.n_steps
    ladder = (1, steps - 1, steps + 50, 1 << 20)      # steps is just above
    walked = []
    for name in ("_walk_batch_impl", "_walk_batch_symbol_impl"):
        plain = getattr(rd, name)

        def record(*a, _plain=plain, **kw):
            walked.append(kw["n_steps"])
            return _plain(*a, **kw)
        monkeypatch.setattr(rd, name, record)
    js = JSession(jm, impl="jnp", layout=layout, policy=JLadder(ladder))
    ts = DecoderSession(_port_model(jm), device="cpu", layout=layout,
                        policy=LadderBucketPolicy(ladder))
    jds, tds = js.upload_stream(enc.stream), ts.upload_stream(enc.stream)
    if layout == "symbol":
        jds = j_with_symbol_layout(jds, enc.k_of_word, n)
        tds = with_symbol_layout(tds, enc.k_of_word, n)
    jplan = js.prepare(jb, jds, n)
    tplan = ts.prepare(tb, tds, n)
    out = ts.execute(tplan).numpy()
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(out, np.asarray(js.execute(jplan)))
    assert walked == [steps] and tplan.n_steps == steps
    assert jplan.statics["n_steps"] == steps + 50       # the bucket
    # The key's buckets are the reference's, steps bucket included.
    assert tplan.key[:3] == ("torch", layout, jplan.key[2])
    assert tplan.key[3:8] == jplan.key[3:8]
    assert tplan.key[7] == steps + 50

"""The port's chunk axis and streaming decode on the CPU against the JAX
package's (``impl="jnp"``).

The same seeded content goes through both packages: ``chunk_walk_batch``
must give equal chunks field for field, each chunk must decode to its slice
of the symbols and to the reference's chunk, a chunk must decode from its
``words_end`` word prefix alone (a zeroed tail, and a stream holding only
the prefix), and ``DecodeService``'s streaming surface (``decode_chunks``,
``submit_stream``, ``stream_chunk_count``, ``StreamTicket``) must return
what the reference's does, with equal counters.  The chunked wire container
must be byte-equal and decode chunk by chunk from its directory's prefixes.
Through the pipeline broker: extends racing in-flight decodes (every
response is one version's complete asset, never a mix), ``submit_stream``
routed to the broker's decode worker, and ``extend`` invalidating the
capability registry's memos.  Every comparison is an exact equality
(integer codec); every broker wait has a timeout of at most 30 s.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import container as j_container
from repro.core import recoil as j_recoil
from repro.core.engine import DecoderSession as JSession
from repro.core.engine import chunk_bounds as j_chunk_bounds
from repro.core.engine import chunk_walk_batch as j_chunk_walk_batch
from repro.core.engine import with_symbol_layout as j_with_symbol_layout
from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.core.vectorized import WalkBatch as JBatch
from repro.core.vectorized import encode_interleaved_fast as j_encode
from repro.runtime.serve import DecodeService as JService
from repro.runtime.serve import StreamTicket as JStreamTicket

STREAM_COUNTERS = ("compiles", "cache_hits", "decodes", "plan_hits",
                   "plan_misses", "stream_requests", "symbol_plans",
                   "pointer_plans")


def _model():
    rng = np.random.default_rng(932)
    ref = np.concatenate([
        np.minimum(rng.exponential(40.0, size=50_000).astype(np.int64), 255),
        np.arange(256)])
    return JModel.from_symbols(ref, 256, JParams(n_bits=11, ways=32))


def _symbols(seed, n):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)


def _port_model(jm):
    from repro_torch.core import convert
    return convert.model_from_arrays(jm.f, jm.F, jm.params.n_bits,
                                     jm.params.ways)


def _port_plan(jp):
    from repro_torch.core import convert
    return convert.plan_from_arrays(**convert.plan_arrays(jp))


def _content(seed, n, n_splits):
    jm = _model()
    syms = _symbols(seed, n)
    enc = j_encode(syms, jm)
    return jm, syms, enc, j_recoil.plan_splits(enc, n_splits)


def _batches(jm, enc, plan, n_threads):
    """The reference's thinned WalkBatch and the port's, each built by its
    own package from the same plan."""
    from repro_torch.core import recoil
    from repro_torch.core.vectorized import WalkBatch
    W = jm.params.ways
    jthin = j_recoil.combine_plan(plan, n_threads)
    jb = JBatch.from_splits(
        j_recoil.build_split_states(jthin, enc.final_states), W)
    tthin = recoil.combine_plan(_port_plan(plan), n_threads)
    tb = WalkBatch.from_splits(
        recoil.build_split_states(tthin, enc.final_states), W)
    return jb, tb


def _streams(jm, enc, n, layout):
    """Both packages' sessions and resident streams on ``layout``."""
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    js = JSession(jm, impl="jnp")
    ts = DecoderSession(_port_model(jm), device="cpu")
    jds = js.upload_stream(enc.stream)
    tds = ts.upload_stream(enc.stream)
    if layout == "symbol":
        jds = j_with_symbol_layout(jds, enc.k_of_word, n)
        tds = with_symbol_layout(tds, enc.k_of_word, n)
    return js, jds, ts, tds


def _prefix_stream(words, n):
    """A resident stream holding ONLY the first ``n`` words (no bucket
    padding), so any read past the prefix has nothing to read."""
    import torch
    from repro_torch.core.engine import DeviceStream
    host = np.asarray(words[:n], np.uint16)
    return DeviceStream(words=torch.from_numpy(host.view(np.int16).copy()),
                        host=host, n_words=n, bucket=n)


@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@in_child
def test_chunk_walk_batch_fields_equal(n_chunks, layout):
    """Chunks field for field; on the symbol layout the batch carries its
    permutation bases, which each chunk must slice like the reference."""
    from repro_torch.core.engine import chunk_walk_batch
    from repro_torch.core.vectorized import WalkBatch as TBatch
    jm, syms, enc, plan = _content(1, 20_000, 16)
    jb, tb = _batches(jm, enc, plan, 16)
    if layout == "symbol":
        bases = (np.arange(jb.k.shape[0], dtype=np.int32) * 7) * 32
        jb = JBatch(**{**jb.__dict__, "sym_base": bases})
        tb = TBatch(**{**tb.__dict__, "sym_base": bases.copy()})
    jspecs = j_chunk_walk_batch(jb, len(syms), n_chunks)
    tspecs = chunk_walk_batch(tb, len(syms), n_chunks)
    assert len(tspecs) == len(jspecs) == min(n_chunks, 16)
    for t, j in zip(tspecs, jspecs):
        assert (t.base, t.length, t.words_end) == \
            (j.base, j.length, j.words_end)
        assert (t.batch.n_steps, t.batch.ways) == \
            (j.batch.n_steps, j.batch.ways)
        for field in ("k", "y", "x0", "q0", "g_hi", "start", "stop",
                      "keep_lo", "keep_hi", "out_base", "sym_base"):
            a, b = getattr(t.batch, field), getattr(j.batch, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=field)
                assert a.dtype == b.dtype, field


@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@in_child
def test_chunked_decode_matches_reference(n_chunks, layout):
    from repro_torch.core.engine import chunk_walk_batch
    jm, syms, enc, plan = _content(7, 20_000, 16)
    js, jds, ts, tds = _streams(jm, enc, len(syms), layout)
    jb, tb = _batches(jm, enc, plan, 16)
    jspecs = j_chunk_walk_batch(jb, len(syms), n_chunks)
    parts = []
    for spec, jspec in zip(chunk_walk_batch(tb, len(syms), n_chunks),
                           jspecs):
        tplan = ts.prepare(spec.batch, tds, spec.length)
        assert tplan.layout == layout and tplan.covered
        out = ts.execute(tplan).numpy()
        want = np.asarray(js.execute(js.prepare(jspec.batch, jds,
                                                jspec.length)))
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(
            out, syms[spec.base:spec.base + spec.length])
        parts.append(out)
    np.testing.assert_array_equal(np.concatenate(parts), syms)
    assert ts.stats.snapshot() == js.stats.snapshot()


@pytest.mark.parametrize("upload", ["zeroed_tail", "prefix_only"])
@in_child
def test_chunk_reads_only_its_word_prefix(upload):
    """Chunk c decodes from the first ``words_end[c]`` words: with every
    later word zeroed (the reference's check) and from a stream that holds
    nothing past the prefix.  Pointer layout only: the symbol layout's
    permutation is not a prefix of the wire stream."""
    from repro_torch.core.engine import DecoderSession, chunk_walk_batch
    jm, syms, enc, plan = _content(8, 12_000, 12)
    js = JSession(jm, impl="jnp")
    ts = DecoderSession(_port_model(jm), device="cpu")
    jb, tb = _batches(jm, enc, plan, 12)
    specs = chunk_walk_batch(tb, len(syms), 4)
    for spec, jspec in zip(specs, j_chunk_walk_batch(jb, len(syms), 4)):
        trunc = enc.stream.copy()
        trunc[spec.words_end:] = 0
        tds = (ts.upload_stream(trunc) if upload == "zeroed_tail"
               else _prefix_stream(enc.stream, spec.words_end))
        out = ts.execute(ts.prepare(spec.batch, tds, spec.length)).numpy()
        np.testing.assert_array_equal(
            out, syms[spec.base:spec.base + spec.length],
            err_msg=f"chunk at base {spec.base} read past words_end="
                    f"{spec.words_end}")
        want = np.asarray(js.execute(js.prepare(
            jspec.batch, js.upload_stream(trunc), jspec.length)))
        np.testing.assert_array_equal(out, want)


@in_child
def test_chunk_bounds_cover_rows():
    from repro_torch.core.engine import chunk_bounds
    for n_rows in (1, 5, 12, 64):
        for n_chunks in (1, 2, 7, 64, 100):
            b = chunk_bounds(n_rows, n_chunks)
            assert b == j_chunk_bounds(n_rows, n_chunks)
            assert b[0][0] == 0 and b[-1][1] == n_rows
            assert all(r0 < r1 for r0, r1 in b)
            assert all(p[1] == q[0] for p, q in zip(b, b[1:]))
            assert len(b) == min(n_chunks, n_rows)


def _services(layout):
    """Both services holding one content, registered with its emission log
    (symbol layout) or without (pointer layout)."""
    from repro_torch.runtime.serve import DecodeService
    jm, syms, enc, plan = _content(25, 24_000, 16)
    log = enc.k_of_word if layout == "symbol" else None
    jsvc = JService(jm, impl="jnp")
    tsvc = DecodeService(_port_model(jm), device="cpu")
    jsvc.register("a", plan, enc.stream, enc.final_states, emission_log=log)
    tsvc.register("a", _port_plan(plan), enc.stream, enc.final_states,
                  emission_log=log)
    assert tsvc.layout_for("a") == jsvc.layout_for("a") == layout
    return syms, jsvc, tsvc


def _counters(svc):
    snap = svc.stats.snapshot()
    return {k: snap[k] for k in STREAM_COUNTERS}


@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_service_streams_match_reference(layout):
    import torch
    syms, jsvc, tsvc = _services(layout)
    cases = [(16, 1), (16, 3), (16, 8), (5, 3), (2, 9)]
    for rnd in range(2):       # the second round is warm: memo hits only
        compiles = tsvc.stats.compiles
        for n_threads, n_chunks in cases:
            count = tsvc.stream_chunk_count("a", n_threads, n_chunks)
            assert count == jsvc.stream_chunk_count("a", n_threads, n_chunks)
            assert count == min(n_chunks, n_threads)
            parts = tsvc.decode_chunks("a", n_threads, n_chunks)
            jparts = jsvc.decode_chunks("a", n_threads, n_chunks)
            assert len(parts) == len(jparts) == count
            for p, jp in zip(parts, jparts):
                np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
            t = tsvc.submit_stream("a", n_threads, n_chunks)
            jt = jsvc.submit_stream("a", n_threads, n_chunks)
            assert t.n_chunks == jt.n_chunks == count
            assert [(s.base, s.length, s.words_end) for s in t.specs] == \
                [(s.base, s.length, s.words_end) for s in jt.specs]
            assert [s.base for s in t.specs] == \
                list(np.cumsum([0] + [s.length for s in t.specs[:-1]]))
            ends = [s.words_end for s in t.specs]
            assert ends == sorted(ends) and ends[-1] == len(
                tsvc.content("a").stream.host)
            for i, spec in enumerate(t.specs):
                got = t.synchronize(i)   # the CPU chunk is ready at launch
                np.testing.assert_array_equal(
                    got.numpy(), syms[spec.base:spec.base + spec.length])
            whole = t.result()
            assert isinstance(whole, torch.Tensor)
            np.testing.assert_array_equal(whole.numpy(), syms)
            np.testing.assert_array_equal(
                whole.numpy(), tsvc.decode("a", n_threads).numpy())
            jsvc.decode("a", n_threads)
            assert t.completed_at >= t.first_chunk_at >= t.submitted_at
            assert all(p.covered
                       for p, _ in tsvc._chunked_plans("a", n_threads,
                                                       n_chunks))
            jsvc._chunked_plans("a", n_threads, n_chunks)
        assert _counters(tsvc) == _counters(jsvc)
        if rnd:
            assert tsvc.stats.compiles == compiles, \
                "a warm stream resolved a new launcher"


@in_child
def test_stream_ticket_error_propagates():
    from repro_torch.runtime.serve import StreamTicket
    syms, jsvc, tsvc = _services("symbol")
    bad = StreamTicket(99)    # wrong chunk count for the request
    with pytest.raises(ValueError, match="99 chunks"):
        tsvc.dispatch_stream("a", 8, 4, bad)
    with pytest.raises(ValueError, match="99 chunks"):
        bad.chunk(0)          # the failure is delivered to waiters too
    with pytest.raises(ValueError, match="99 chunks"):
        bad.synchronize(98)
    jbad = JStreamTicket(99)
    with pytest.raises(ValueError, match="99 chunks"):
        jsvc.dispatch_stream("a", 8, 4, jbad)
    assert tsvc.stats.stream_requests == jsvc.stats.stream_requests == 1
    # The service still streams after the failed dispatch.
    np.testing.assert_array_equal(
        tsvc.submit_stream("a", 8, 4).result().numpy(), syms)


@in_child
def test_chunked_container_round_trip_and_prefix_decode():
    from repro_torch.core import container, recoil
    from repro_torch.core.engine import DecoderSession, chunk_walk_batch
    from repro_torch.core.vectorized import (WalkBatch,
                                             encode_interleaved_fast)
    jm = _model()
    model = _port_model(jm)
    syms = _symbols(30, 9_000)
    enc = encode_interleaved_fast(syms, model)
    plan = recoil.plan_splits(enc, 12)
    buf = container.pack_recoil_chunked(enc, model, plan, 4)
    jenc = j_encode(syms, jm)
    assert buf == j_container.pack_recoil_chunked(
        jenc, jm, j_recoil.plan_splits(jenc, 12), 4)
    parsed = container.parse(buf, model.params)
    assert parsed.kind == container.KIND_RECOIL_CHUNKED
    assert parsed.chunks.n_chunks == 4
    np.testing.assert_array_equal(parsed.stream, enc.stream)
    assert buf.endswith(enc.stream.astype("<u2").tobytes())
    sess = DecoderSession(model, device="cpu")
    batch = WalkBatch.from_splits(
        recoil.build_split_states(parsed.plan, parsed.final_states),
        plan.ways)
    specs = chunk_walk_batch(batch, len(syms), 4)
    assert [s.words_end for s in specs] == parsed.chunks.words_end.tolist()
    assert [s.base + s.length for s in specs] == \
        parsed.chunks.sym_end.tolist()
    for c, spec in enumerate(specs):
        n = int(parsed.chunks.words_end[c])
        trunc = parsed.stream.copy()
        trunc[n:] = 0
        for ds in (sess.upload_stream(trunc),
                   _prefix_stream(parsed.stream, n)):
            out = sess.execute(sess.prepare(spec.batch, ds, spec.length))
            np.testing.assert_array_equal(
                out.numpy(), syms[spec.base:spec.base + spec.length])
    assert parsed.chunks.ready(0) == 0
    assert parsed.chunks.ready(int(parsed.chunks.words_end[1])) == 2
    assert parsed.chunks.ready(enc.n_words) == 4


# ----------------------------------------------------------------------
# Through the pipeline broker
# ----------------------------------------------------------------------

T = 30.0    # every broker wait here is bounded


def _port_service():
    from repro_torch.runtime.serve import DecodeService
    return DecodeService(_port_model(_model()), device="cpu")


def _stream_symbols(st):
    return np.concatenate([st.chunk(i, timeout=T).numpy()
                           for i in range(st.n_chunks)])


@in_child
def test_service_extend_generation_and_memo_invalidation():
    from repro_torch.core import container
    svc = _port_service()
    base = _symbols(20, 10_000)
    svc.ingest("a", base, 16)
    np.testing.assert_array_equal(svc.decode("a", 8).numpy(), base)
    gen = svc.generation("a")
    broker = svc.start_pipeline()
    try:
        reg = broker.registry
        reg.declare("phone", 8)
        plan1 = reg.plan_for("a", "phone")     # memoized at gen
        assert plan1.n_symbols == len(base)
        delta = _symbols(21, 700)
        svc.extend("a", delta)
        grown = np.concatenate([base, delta])
        assert svc.generation("a") == gen + 1
        # the per-(name, n_threads) plan memo was invalidated: the decode
        # reflects the grown asset, not the stale plan
        np.testing.assert_array_equal(svc.decode("a", 8).numpy(), grown)
        # capability-registry memo re-derives against the new generation
        plan2 = reg.plan_for("a", "phone")
        assert plan2.n_symbols == len(grown) != plan1.n_symbols
        # ...and the thinned wire payload serves the grown asset too
        buf = reg.container_for("a", "phone")
        parsed = container.parse(buf, svc.session.model.params)
        assert parsed.n_symbols == len(grown)
        jbuf = j_container.parse(buf, _model().params)
        assert jbuf.n_symbols == len(grown)
    finally:
        svc.stop_pipeline()


@in_child
def test_extend_during_inflight_decode_via_broker():
    """Extends racing decode traffic through the broker: every response is
    internally consistent (some version's complete asset), and a decode
    after the last extend ticket resolves serves the grown asset."""
    svc = _port_service()
    base = _symbols(22, 20_000)
    svc.ingest("a", base, 16)
    versions = [base]
    broker = svc.start_pipeline()
    try:
        tickets = [svc.submit("a", 8) for _ in range(6)]
        ext = []
        for i in range(3):
            delta = _symbols(23 + i, 1_000)
            versions.append(np.concatenate([versions[-1], delta]))
            ext.append(broker.submit_extend("a", delta))
            tickets.extend(svc.submit("a", 8) for _ in range(4))
        for t in ext:
            t.result(timeout=T)
        broker.drain(timeout=T)
        for t in tickets:
            out = t.result(timeout=T).numpy()
            assert any(len(v) == len(out) and (out == v).all()
                       for v in versions), "response matches no version"
        # post-drain: the newest version serves
        np.testing.assert_array_equal(svc.decode("a", 8).numpy(),
                                      versions[-1])
        assert broker.snapshot()["extend_events"] == 3
    finally:
        svc.stop_pipeline()


@in_child
def test_submit_stream_sync_and_broker():
    svc = _port_service()
    syms = _symbols(25, 24_000)
    svc.ingest("a", syms, 16)
    t = svc.submit_stream("a", 16, n_chunks=4)
    # per-chunk arrival order + reassembly
    got = [c.numpy() for c in t]
    assert len(got) == 4 and (np.concatenate(got) == syms).all()
    assert t.first_chunk_at is not None
    assert t.completed_at >= t.first_chunk_at >= t.submitted_at
    assert [s.base for s in t.specs] == \
        list(np.cumsum([0] + [s.length for s in t.specs[:-1]]))
    # clamped chunk count
    assert svc.submit_stream("a", 2, n_chunks=9).n_chunks == 2
    broker = svc.start_pipeline()
    try:
        bt = svc.submit_stream("a", 16, n_chunks=4)   # routes via broker
        np.testing.assert_array_equal(_stream_symbols(bt), syms)
        assert bt.trace.meta.get("path") != "sync"
        assert [(s.base, s.length, s.words_end) for s in bt.specs] == \
            [(s.base, s.length, s.words_end) for s in t.specs]
        with pytest.raises(KeyError):
            broker.submit_stream("nope", 8)
        broker.drain(timeout=T)
        assert broker.snapshot()["stream_dispatches"] >= 1
    finally:
        svc.stop_pipeline()

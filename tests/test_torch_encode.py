"""The port's ingest engine on the CPU against the JAX package's
``EncoderSession``.

Both sessions encode and split-plan the same seeded content.  The stream
words, the emission log (``k_of_word``, ``y_of_word``), the final states,
the Definition-4.1 split points and the symbol-indexed permutation must be
equal (the codec is integer-exact), for static and adaptive models, for
extends and batches, and the ingested content must decode through the
port's ``DecoderSession``.  Permutation entries are compared as 16-bit
words: the port stores them as int16 bit patterns.

One JAX session serves every case of a model where the cases allow it,
since each new JAX shape bucket compiles an executable.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import recoil as j_recoil
from repro.core.adaptive import ContextModel as JContextModel
from repro.core.encode import EncoderSession as JEncoder
from repro.core.encode.ops import encode_scan as j_encode_scan
from repro.core.interleaved import encode_interleaved as j_encode_oracle
from repro.core.rans import RansParams as JParams, StaticModel as JModel

PARAMS = JParams(n_bits=11, ways=32)
_J_SESSIONS: dict = {}


def _symbols(seed, n, lam=40.0):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.exponential(lam, size=n).astype(np.int64), 255)


def _jmodel(ways=32, n_bits=11):
    syms = np.concatenate([_symbols(500 + ways, 60_000), np.arange(256)])
    return JModel.from_symbols(syms, 256, JParams(n_bits=n_bits, ways=ways))


def _shared(ways=32):
    """One model and one JAX session per ways, shared across cases."""
    if ways not in _J_SESSIONS:
        jm = _jmodel(ways)
        _J_SESSIONS[ways] = (jm, JEncoder(jm))
    return _J_SESSIONS[ways]


def _port(jm, device="cpu", **kw):
    from repro_torch.core import convert
    from repro_torch.core.encode import EncoderSession
    tm = convert.model_from_arrays(jm.f, jm.F, jm.params.n_bits,
                                   jm.params.ways)
    return tm, EncoderSession(tm, device=device, **kw)


def _assert_plans_equal(got, want):
    assert (got.n_symbols, got.n_words, got.ways) == \
        (want.n_symbols, want.n_words, want.ways)
    assert len(got.points) == len(want.points)
    for a, b in zip(got.points, want.points):
        assert a.offset == b.offset
        np.testing.assert_array_equal(a.k, b.k)
        np.testing.assert_array_equal(a.y, b.y)


def _assert_results_equal(t, j):
    """A port IngestResult against the JAX one, field by field."""
    assert t.n_words == j.n_words
    assert t.stream.host is None
    assert (t.stream.bucket, t.stream.sym_bucket) == \
        (j.stream.bucket, j.stream.sym_bucket)
    np.testing.assert_array_equal(
        t.stream.words.numpy().view(np.uint16),
        np.asarray(j.stream.words).astype(np.uint16))
    np.testing.assert_array_equal(t.final_states, j.final_states)
    np.testing.assert_array_equal(
        t.stream.by_symbol.numpy().astype(np.int64) & 0xFFFF,
        np.asarray(j.stream.by_symbol).astype(np.int64) & 0xFFFF)
    _assert_plans_equal(t.plan, j.plan)


def _assert_encoded_equal(t, j):
    for field in ("stream", "final_states", "k_of_word", "y_of_word"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field),
                                      err_msg=field)
        assert getattr(t, field).dtype == getattr(j, field).dtype, field
    assert t.n_symbols == j.n_symbols


# ---------------------------------------------------------------------------
# Encode parity (stream + emission log + final states)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 31, 32, 1_000, 8_192, 20_013])
@in_child
def test_encode_matches_reference(n):
    jm, jsess = _shared()
    _, tsess = _port(jm)
    syms = _symbols(n, n)
    _assert_encoded_equal(tsess.encode(syms), jsess.encode(syms))


@pytest.mark.parametrize("ways", [8, 16, 64, 128])
@in_child
def test_ingest_at_other_ways_matches_reference(ways):
    """Narrow interleaves share a warp between lanes of one content on the
    card; wide ones span several warps.  Stream, states, plan and
    permutation equal the reference's."""
    jm, jsess = _shared(ways)
    _, tsess = _port(jm)
    syms = _symbols(ways, 12_007)
    _assert_results_equal(tsess.ingest(syms, 8), jsess.ingest(syms, 8))


@in_child
def test_encode_scan_op_matches_reference():
    """``ops.encode_scan`` on one [G, W] grid with lead slots and a resumed
    x0 against the reference's ``encode_scan``, every output."""
    import torch
    from repro_torch.core.encode import ops
    jm, _ = _shared()
    W = 32
    rng = np.random.default_rng(7)
    syms = _symbols(8, 5_000)
    head = 13
    G = -(-(head + syms.size) // W)
    grid = np.zeros(G * W, np.int32)
    active = np.zeros(G * W, bool)
    grid[head:head + syms.size] = syms
    active[head:head + syms.size] = True
    grid, active = grid.reshape(G, W), active.reshape(G, W)
    x0 = rng.integers(1 << 16, 1 << 32, size=W, dtype=np.uint64).astype(
        np.uint32)
    (jf, jz), (jw, jmask, jy) = j_encode_scan(
        jnp.asarray(grid), jnp.asarray(active),
        jnp.asarray(jm.f.astype(np.int32)), jnp.asarray(jm.F.astype(np.int32)),
        11, W, x0=x0)
    (tf, tz), (tw, tmask, ty) = ops.encode_scan(
        torch.as_tensor(grid), torch.as_tensor(active),
        torch.as_tensor(jm.f.astype(np.int32)),
        torch.as_tensor(jm.F.astype(np.int32)), 11, W,
        x0=torch.as_tensor(x0.view(np.int32)))
    np.testing.assert_array_equal(tf.numpy().view(np.uint32), np.asarray(jf))
    assert not bool(tz) and not bool(jz)
    np.testing.assert_array_equal(tw.numpy().view(np.uint16), np.asarray(jw))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(ty.numpy().view(np.uint32), np.asarray(jy))


# ---------------------------------------------------------------------------
# Ingest parity (split metadata + device stream + permutation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_splits", [
    (1_000, 1), (20_011, 2), (20_011, 16), (40_000, 64)])
@in_child
def test_ingest_matches_reference(n, n_splits):
    jm, jsess = _shared()
    _, tsess = _port(jm)
    syms = _symbols(n_splits, n)
    _assert_results_equal(tsess.ingest(syms, n_splits),
                          jsess.ingest(syms, n_splits))


@in_child
def test_emission_layout_scans_long_rows_in_pieces(monkeypatch):
    """A row longer than ``SCAN_PIECE`` is scanned in pieces that carry the
    running count (torch's CUDA cumsum faulted on a 1.73 G-entry row): the
    layout, and the compaction of three contents' emissions in pieces,
    equal the one-piece results, and an ingest through them equals the
    reference's."""
    import torch
    from repro_torch.core.encode import ops
    g = torch.Generator()
    g.manual_seed(0)
    masks = torch.rand((3, 37, 8), generator=g) < 0.4
    words = torch.randint(-2**15, 2**15, masks.shape, generator=g,
                          dtype=torch.int16)
    ys = torch.randint(0, 2**31 - 1, masks.shape, generator=g,
                       dtype=torch.int32)
    whole = ops.emission_layout(masks)
    cap = int(whole[2].max())
    compact = ops.compact_emissions(words, ys, masks, whole[0], cap)
    monkeypatch.setattr(ops, "SCAN_PIECE", 16)
    for got, want in zip(ops.emission_layout(masks), whole):
        assert torch.equal(got, want)
    for got, want in zip(
            ops.compact_emissions(words, ys, masks, whole[0], cap), compact):
        assert torch.equal(got, want)
    monkeypatch.setattr(ops, "SCAN_PIECE", 1024)
    jm, jsess = _shared()
    _, tsess = _port(jm)
    syms = _symbols(16, 20_011)
    _assert_results_equal(tsess.ingest(syms, 16), jsess.ingest(syms, 16))


@in_child
def test_ingest_random_parity_sweep():
    """Random sizes (ragged), rates and split counts, each with its own
    model: the port's plans and streams equal the reference's host oracle
    (``encode_interleaved`` + ``plan_splits``), which the JAX package's
    EncoderSession is held equal to by its own tests."""
    from repro_torch.core import convert
    from repro_torch.core.encode import EncoderSession
    for seed in range(8):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(64, 20_000))
        lam = float(rng.uniform(2, 80))
        syms = np.minimum(rng.exponential(lam, size=n).astype(np.int64), 255)
        jm = JModel.from_symbols(np.concatenate([syms, np.arange(256)]), 256,
                                 PARAMS)
        tsess = EncoderSession(convert.model_from_arrays(jm.f, jm.F, 11, 32),
                               device="cpu")
        ref = j_encode_oracle(syms, jm)
        for n_splits in (1, 3, int(rng.integers(2, 48))):
            res = tsess.ingest(syms, n_splits)
            _assert_plans_equal(res.plan, j_recoil.plan_splits(ref, n_splits))
            np.testing.assert_array_equal(
                res.stream.words[:res.n_words].numpy().view(np.uint16),
                ref.stream)


@in_child
def test_expansion_trigger_matches_reference():
    """A skewed model at 100 splits needs window expansion (the reference's
    fast tier flags it and re-runs); the port evaluates the rounds lazily
    and must land on the same points."""
    syms = _symbols(2, 4_000, lam=2.0)
    jm = JModel.from_symbols(syms, 256, PARAMS)
    jsess = JEncoder(jm)
    want = jsess.ingest(syms, 100)
    assert jsess.stats.fallbacks == 1
    _, tsess = _port(jm)
    _assert_results_equal(tsess.ingest(syms, 100), want)


@in_child
def test_wide_alphabet_over_8_bits_per_symbol_matches_reference():
    """A 4096-symbol alphabet at n = 12 spends more than 8 bits a symbol,
    which overflows the reference's fast stream capacity; the port has no
    capacity tier and must still match."""
    params12 = JParams(n_bits=12, ways=32)
    rng = np.random.default_rng(3)
    syms = rng.integers(0, 4096, size=60_000).astype(np.int64)
    jm = JModel.from_symbols(np.concatenate([syms, np.arange(4096)]), 4096,
                             params12)
    jsess = JEncoder(jm)
    want = jsess.ingest(syms, 8)
    assert jsess.stats.fallbacks == 1
    _, tsess = _port(jm)
    got = tsess.ingest(syms, 8)
    _assert_results_equal(got, want)
    assert got.n_words > syms.size // 2


@in_child
def test_adaptive_ingest_matches_reference_and_round_trips():
    from repro_torch.core import convert
    from repro_torch.core.adaptive import decode_recoil_adaptive
    from repro_torch.core.encode import EncoderSession
    n = 6_005
    ctx = (np.arange(n) % 3).astype(np.int32)
    jcm = JContextModel.from_scale_table([5.0, 15.0, 50.0], ctx, 256, PARAMS)
    tcm = convert.context_model_from_arrays(jcm.f, jcm.F, jcm.ctx, 11, 32)
    np.testing.assert_array_equal(tcm.slot_luts(), jcm.slot_luts())
    syms = _symbols(11, n, lam=25.0)
    tsess = EncoderSession(tcm, device="cpu")
    jsess = JEncoder(jcm)
    _assert_encoded_equal(tsess.encode(syms), jsess.encode(syms))
    got = tsess.ingest(syms, 8)
    _assert_results_equal(got, jsess.ingest(syms, 8))
    words = got.stream.words[:got.n_words].numpy().view(np.uint16)
    np.testing.assert_array_equal(
        decode_recoil_adaptive(got.plan, words, got.final_states, tcm), syms)
    with pytest.raises(ValueError, match="ctx"):
        tsess.ingest(np.concatenate([syms, syms[:5]]), 4)


@in_child
def test_ingest_batch_matches_singles_and_reference():
    jm, jsess = _shared()
    _, tsess = _port(jm)
    contents = [_symbols(m, m) for m in (5_000, 7_777, 6_001)]
    batched = tsess.ingest_batch(contents, 8)
    assert tsess.stats.encodes == 1
    j_batched = jsess.ingest_batch(contents, 8)
    for b, jb, c in zip(batched, j_batched, contents):
        _assert_results_equal(b, tsess.ingest(c, 8))
        _assert_results_equal(b, jb)
    mixed = tsess.ingest_batch(contents[:2], [3, 17])
    _assert_results_equal(mixed[0], tsess.ingest(contents[0], 3))
    _assert_results_equal(mixed[1], tsess.ingest(contents[1], 17))


# ---------------------------------------------------------------------------
# Incremental re-ingest
# ---------------------------------------------------------------------------

@in_child
def test_extend_matches_reference_and_full_reingest():
    """Chained extends from a base whose length is not a multiple of W:
    the port's extend equals the reference's (points included), and its
    stream, states and permutation equal a full re-ingest of the grown
    content."""
    jm, _ = _shared()
    jsess = JEncoder(jm)
    _, tsess = _port(jm)
    base = _symbols(1, 2_999)
    assert base.size % 32
    tsess.ingest(base, 8, name="a")
    jsess.ingest(base, 8, name="a")
    grown = base
    for i, d in enumerate([37, 7, 1]):
        delta = _symbols(100 + i, d)
        grown = np.concatenate([grown, delta])
        got = tsess.extend("a", delta)
        _assert_results_equal(got, jsess.extend("a", delta))
        full = tsess.ingest(grown, got.plan.n_threads)
        assert got.n_words == full.n_words
        np.testing.assert_array_equal(got.stream.words.numpy(),
                                      full.stream.words.numpy())
        np.testing.assert_array_equal(got.stream.by_symbol.numpy(),
                                      full.stream.by_symbol.numpy())
        np.testing.assert_array_equal(got.final_states, full.final_states)
    assert tsess.stats.extends == 3


@in_child
def test_adaptive_extend_matches_reference():
    from repro_torch.core import convert
    from repro_torch.core.encode import EncoderSession
    params = JParams(n_bits=10, ways=16)
    n0, ds = 2_000, [31]
    total = n0 + sum(ds)
    ctx = (np.arange(total) // 257 % 4).astype(np.int32)
    jcm = JContextModel.from_scale_table(
        np.array([8.0, 16.0, 32.0, 64.0]), ctx, 256, params)
    tcm = convert.context_model_from_arrays(jcm.f, jcm.F, jcm.ctx, 10, 16)
    syms = _symbols(5, total)
    jsess, tsess = JEncoder(jcm), EncoderSession(tcm, device="cpu")
    jsess.ingest(syms[:n0], 6, name="a")
    tsess.ingest(syms[:n0], 6, name="a")
    off = n0
    for d in ds:
        got = tsess.extend("a", syms[off:off + d])   # ctx sliced from model
        _assert_results_equal(got, jsess.extend("a", syms[off:off + d]))
        off += d


@in_child
def test_resume_lru_and_missing_state():
    jm, _ = _shared()
    _, tsess = _port(jm, resume_capacity=2)
    base = _symbols(2, 1_000)
    tsess.ingest(base, 4)                          # no name -> no tail
    with pytest.raises(KeyError, match="no resumable ingest state"):
        tsess.extend("a", _symbols(3, 10))
    for name in ("a", "b", "c"):
        tsess.ingest(base, 4, name=name)
    assert tsess.stats.resume_evictions == 1
    assert not tsess.can_extend("a")
    assert tsess.can_extend("b") and tsess.can_extend("c")
    tsess.extend("b", _symbols(4, 10))              # touch b: c is now oldest
    tsess.ingest(base, 4, name="d")
    assert not tsess.can_extend("c") and tsess.can_extend("b")
    assert tsess.stats.resume_evictions == 2
    with pytest.raises(KeyError):
        tsess.extend("a", _symbols(3, 10))
    with pytest.raises(ValueError, match="non-empty"):
        tsess.extend("b", np.array([], np.int64))
    tsess.forget("b")
    assert not tsess.can_extend("b")


# ---------------------------------------------------------------------------
# Input checks, devices and decode of ingested content
# ---------------------------------------------------------------------------

@in_child
def test_bad_inputs_raise():
    import torch
    from repro_torch.core.encode.session import MAX_SYMBOLS
    syms = _symbols(8, 5_000)
    jm = JModel.from_symbols(syms, 256, PARAMS)
    _, tsess = _port(jm)
    with pytest.raises(ValueError, match="alphabet"):
        tsess.ingest(np.array([1, 2, 300]), 2)
    with pytest.raises(ValueError, match="alphabet"):
        tsess.ingest(np.array([-1, 2, 3]), 2)
    missing = np.setdiff1d(np.arange(256), np.unique(syms))
    assert missing.size
    with pytest.raises(ValueError, match="zero quantized frequency"):
        tsess.ingest(np.array([int(missing[0])] * 100), 2)
    with pytest.raises(ValueError, match="at least one"):
        tsess.ingest(np.zeros(10, np.int64), 0)
    huge = torch.zeros(1, dtype=torch.uint8).expand(MAX_SYMBOLS)
    with pytest.raises(ValueError, match="planning range"):
        tsess.ingest(huge, 2)
    with pytest.raises(ValueError, match="integers"):
        tsess.ingest(np.array([1.0, 2.0]), 2)
    with pytest.raises(ValueError, match="static"):
        tsess.ingest(syms[:100], 2, ctx=np.zeros(100, np.int32))


@in_child
def test_session_device_rules_and_tensor_input():
    """The session defaults to the card and raises without one; on the CPU
    only the plain versions run, and a torch tensor of symbols ingests like
    the numpy array it holds."""
    import torch
    from repro_torch.core.encode import EncoderSession
    from repro_torch.kernels.rans_encode import rans_encode
    jm, _ = _shared()
    tm, tsess = _port(jm)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EncoderSession(tm)
    syms = _symbols(9, 3_000)
    rans_encode.reset_counts()
    a = tsess.ingest(syms, 6)
    b = tsess.ingest(torch.as_tensor(syms.astype(np.uint8)), 6)
    _assert_results_equal(a, b)
    assert rans_encode.encode_scan.plain_calls == 2
    assert rans_encode.plan_splits.plain_calls == 2
    assert rans_encode.encode_scan.launches == 0


@in_child
def test_ingested_content_decodes_through_port_decoder():
    from repro_torch.core.engine import DecoderSession
    jm, _ = _shared()
    tm, tsess = _port(jm)
    syms = _symbols(9, 25_007)
    res = tsess.ingest(syms, 12)
    dec = DecoderSession(tm, device="cpu")
    out = dec.decode(res.plan, res.stream, res.final_states)
    np.testing.assert_array_equal(out.numpy(), syms)
    # The stream resides at the bucket an upload of the same words gets.
    up = dec.upload_stream(res.stream.words[:res.n_words].numpy().view(
        np.uint16))
    assert up.bucket == res.stream.bucket


# ---------------------------------------------------------------------------
# The encoder records (kernels/rans_encode encoder_table) and their owner
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _step_terms(records):
    """Encoder records' words as uint64 columns: (thr, mlo, bias, cs,
    complement) -- the complement is cs >> 5 read as signed."""
    rec = records.numpy().view(np.uint32).astype(np.uint64)
    cmpl = (rec[..., 3].astype(np.uint32).view(np.int32) >> 5).astype(
        np.int64).astype(np.uint64)
    return rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3], cmpl


def _quotient(x1, mlo, cs):
    """The kernel's quotient, in uint64 with its u32 masks: the 33-bit sum
    x1 + umulhi(x1, mlo), shifted right by cs & 31 (the funnel shift's
    wrap), low 32 bits."""
    s = (x1 + ((x1 * mlo) >> np.uint64(32))) >> (cs & np.uint64(31))
    return s & np.uint64(M32)


def _renormalizes(x, thr):
    """(x >> 1) + thr as a signed 32-bit value is >= 0."""
    return (((x >> np.uint64(1)) + thr) & np.uint64(M32)) < np.uint64(1 << 31)


@pytest.mark.parametrize("n_bits", [11, 12, 16])
@in_child
def test_encoder_table_magic_is_exact_for_every_frequency(n_bits):
    """For every f in [1, 2^16]: s = ceil(log2 f), the magic number meets
    Granlund and Montgomery's condition 0 <= m f - 2^(32+s) <= 2^s, and the
    kernel's u32 formula gives floor(x1 / f) at k f - 1 and k f for k from 1
    to the largest u32 multiple, and at the largest dividend a step can
    take (f 2^(32-n) - 1, or 2^32 - 1); its threshold renormalizes exactly
    when x > xmax around xmax."""
    import torch
    from repro_torch.kernels.rans_encode.rans_encode import encoder_table
    f = np.arange(1, (1 << 16) + 1, dtype=np.int64)
    table = encoder_table(torch.as_tensor(f.astype(np.int32)),
                          torch.zeros(f.size + 1, dtype=torch.int32), n_bits)
    assert (table.n_bits, table.contexts, table.alphabet) == \
        (n_bits, 1, f.size)
    thr, mlo, _, cs, _ = _step_terms(table.records[:f.size])
    s = (cs & np.uint64(31)).astype(np.int64)
    want_s = np.array([(int(v) - 1).bit_length() for v in f])
    np.testing.assert_array_equal(s, want_s)
    m = mlo.astype(np.int64) + (1 << 32)
    err = m * f - (np.int64(1) << (32 + s))
    assert (err >= 0).all() and (err <= (np.int64(1) << s)).all()
    np.testing.assert_array_equal(
        table.records[:f.size, 3].numpy() >> 5, (1 << n_bits) - f)
    fu = f.astype(np.uint64)
    top = np.minimum(fu << np.uint64(32 - n_bits), np.uint64(1 << 32)) - \
        np.uint64(1)
    kmax = np.uint64(M32) // fu
    rng = np.random.default_rng(n_bits)
    ks = [np.ones_like(fu), np.full_like(fu, 2), kmax // np.uint64(2),
          kmax - np.uint64(1), kmax,
          np.maximum(np.uint64(1), (rng.random(f.size) * kmax).astype(
              np.uint64))]
    points = [top, np.zeros_like(fu)]
    for k in ks:
        k = np.maximum(k, np.uint64(1))
        points += [k * fu - np.uint64(1), np.minimum(k * fu, np.uint64(M32))]
    for x1 in points:
        np.testing.assert_array_equal(_quotient(x1, mlo, cs), x1 // fu)
    for x in (top - np.uint64(1), top, np.minimum(top + np.uint64(1),
                                                  np.uint64(M32))):
        np.testing.assert_array_equal(_renormalizes(x, thr), x > top)


def _emulate_encode(table, sym, active, x0, ctx=None):
    """The encode scan from the encoder records, step by step in uint64
    with the kernel's u32 masks; returns the plain version's five outputs
    as numpy arrays (words u16, masks, ys u32, final u32, zero_freq)."""
    thr, mlo, bias, cs, cmpl = _step_terms(table.records)
    C, A = table.contexts, table.alphabet
    s = sym.numpy().astype(np.int64)
    c = (np.zeros_like(s) if ctx is None
         else np.clip(ctx.numpy().astype(np.int64), 0, C - 1))
    idx = np.where(active.numpy(), c * (A + 1) + np.where(
        (s >= 0) & (s < A), s, A), C * (A + 1))
    x = x0.numpy().view(np.uint32).astype(np.uint64)
    xs = np.zeros(s.shape, np.uint64)
    for g in range(s.shape[1]):
        i = idx[:, g]
        xs[:, g] = x
        x1 = np.where(_renormalizes(x, thr[i]), x >> np.uint64(16), x)
        q = _quotient(x1, mlo[i], cs[i])
        x = (x1 + bias[i] + q * cmpl[i]) & np.uint64(M32)
    emit = _renormalizes(xs, thr[idx])
    ys = np.where(emit, xs >> np.uint64(16), xs)
    zero = (thr[idx] == 0).reshape(s.shape[0], -1).any(1)
    return (xs & np.uint64(0xFFFF)).astype(np.uint16), emit, \
        ys.astype(np.uint32), x.astype(np.uint32), zero


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("ways", [8, 32, 128])
@in_child
def test_table_driven_step_equals_plain_encode(ways, adaptive):
    """The records, stepped as the kernel steps them, give every output of
    ``encode_scan_plain``: three ragged contents with resume lead slots,
    random x0 (with the edge states 0, 1, 2^16 - 1, 2^16 and 2^32 - 1, the
    first under an active zero-frequency symbol), symbols outside the
    alphabet, f = 0, f = 1 and f = 2^n, static or a 2-D adaptive table."""
    import torch
    from repro_torch.core.encode.executors import scan_grids
    from repro_torch.kernels.rans_encode.rans_encode import (
        encode_scan_plain, encoder_table)
    rng = np.random.default_rng(ways + adaptive)
    n_bits, A, C = 11, 300, (4 if adaptive else 1)
    f = rng.integers(0, 1 << n_bits, size=(C, A))
    f[:, 5], f[:, 7], f[:, 9] = 0, 1 << n_bits, 1
    F = rng.integers(0, 1 << n_bits, size=(C, A + 1))
    f_tab = torch.as_tensor(f.astype(np.int32))
    F_tab = torch.as_tensor(F.astype(np.int32))
    if not adaptive:
        f_tab, F_tab = f_tab[0], F_tab[0]
    rows = []
    for n, head in ((ways * 7 + 3, 0), (ways * 3, ways - 1), (17, 5)):
        syms = torch.as_tensor(rng.integers(-3, A + 3, size=n).astype(
            np.int32))
        ctx = (torch.as_tensor(rng.integers(-1, C + 1, size=n).astype(
            np.int32)) if adaptive else None)
        rows.append((head, syms, ctx))
    rows[0][1][0] = 5                    # f = 0 at x0 = 0 in way 0
    x0 = rng.integers(0, 1 << 32, size=(3, ways), dtype=np.uint64).astype(
        np.uint32)
    x0[0, :5] = [0, 1, 0xFFFF, 0x10000, M32]
    sym, active, ctx, x0_t = scan_grids(rows, ways, "cpu", adaptive,
                                        torch.as_tensor(x0.view(np.int32)))
    table = encoder_table(f_tab, F_tab, n_bits)
    got = _emulate_encode(table, sym, active, x0_t, ctx)
    words, masks, ys, final, zero = encode_scan_plain(
        sym, active, f_tab, F_tab, x0_t, ctx, n_bits=n_bits)
    np.testing.assert_array_equal(got[0], words.numpy().view(np.uint16))
    np.testing.assert_array_equal(got[1], masks.numpy())
    np.testing.assert_array_equal(got[2], ys.numpy().view(np.uint32))
    np.testing.assert_array_equal(got[3], final.numpy().view(np.uint32))
    np.testing.assert_array_equal(got[4], zero.numpy())
    assert zero.numpy()[0]               # content 0 opens with f = 0,
    assert masks.numpy()[0, 0, 0]        # which emits even at x = 0


@in_child
def test_encode_executor_builds_its_table_once():
    """The session's executor builds the encoder records once; two ingests
    and an extend hand the wrapper that same tensor.  A table of another
    n_bits, of another model's shape, or with records of the wrong dtype
    raises."""
    import dataclasses

    import torch
    from repro_torch.core.encode import EncoderSession, ops
    from repro_torch.kernels.rans_encode import rans_encode
    jm, _ = _shared()
    tm, _ = _port(jm)
    builds, tables = [], []
    build, scan = rans_encode.encoder_table, ops.encode_scan

    def counting_build(*a, **kw):
        builds.append(1)
        return build(*a, **kw)

    def spying_scan(*a, **kw):
        tables.append(kw["table"])
        return scan(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(rans_encode, "encoder_table", counting_build)
    mp.setattr(ops, "encode_scan", spying_scan)
    try:
        sess = EncoderSession(tm, device="cpu")
        syms = _symbols(21, 3_000)
        sess.ingest(syms, 4, name="a")
        sess.ingest(syms[:1_000], 2)
        sess.extend("a", _symbols(22, 77))
    finally:
        mp.undo()
    assert len(builds) == 1
    assert len(tables) == 3
    assert all(t is sess.executor.table for t in tables)
    ex = sess.executor
    args = (torch.zeros((1, 2, 32), dtype=torch.int32),
            torch.ones((1, 2, 32), dtype=torch.bool), ex.f_tab, ex.F_tab,
            torch.full((1, 32), 1 << 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_bits"):
        rans_encode.encode_scan(*args, n_bits=11, table=build(
            ex.f_tab, ex.F_tab, 12))
    with pytest.raises(ValueError, match="table"):
        rans_encode.encode_scan(*args, n_bits=11, table=build(
            ex.f_tab[:100], ex.F_tab[:101], 11))
    with pytest.raises(ValueError, match="table"):
        rans_encode.encode_scan(*args, n_bits=11, table=dataclasses.replace(
            ex.table, records=ex.table.records.long()))
    got = rans_encode.encode_scan(*args, n_bits=11, table=ex.table)
    want = rans_encode.encode_scan_plain(*args, n_bits=11)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The split planner's decomposition (kernels/rans_encode): a cover pass over
# every word, a slot chain over k_of_word and c alone, an emit step
# ---------------------------------------------------------------------------

def _assert_cover_identities(kw, last, n_words, cover):
    """The four facts the decomposition rests on, on every word q of every
    content, against the oracle-shaped backward scan: c is the scan's
    least k_j (-1 past n_words); a = max_j k_j equals k_of_word[q]; c >= 0
    exactly when every way has emitted at or below q; c never decreases."""
    import torch
    from repro_torch.kernels.rans_encode.rans_encode import _scan_candidates
    W = last.shape[2]
    lanes = torch.arange(W)
    for b, NW in enumerate(n_words.tolist()):
        assert (cover[b, NW:] == -1).all()
        if NW == 0:
            continue
        g2, ok = _scan_candidates(kw[b], last[b], torch.arange(NW), W)
        k = g2 * W + lanes
        c = cover[b, :NW].long()
        assert torch.equal(c, k.min(1).values)
        assert torch.equal(k.max(1).values, kw[b, :NW].long())
        assert torch.equal(c >= 0, ok)
        assert bool((c[1:] >= c[:-1]).all())
        assert not bool(ok.all()), "no word without full cover: weak case"


def _assert_plans_agree(args, yw, window, n_slots):
    """plan_splits (the CPU path), plan_splits_by_cover and
    plan_splits_plain are equal, and each content's found slots equal
    heuristic.plan_split_offsets; returns the plan and its won rounds."""
    import torch
    from torch_checks import won_rounds

    from repro_torch.core import heuristic
    from repro_torch.kernels.rans_encode import rans_encode
    st = dict(window=window, n_slots=n_slots)
    want = rans_encode.plan_splits_plain(*args, **st)
    for got in (rans_encode.plan_splits_by_cover(*args, **st),
                rans_encode.plan_splits(*args, **st)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    kw, csum, last, _, n_words, n_symbols, n_splits = args
    W = last.shape[2]
    for b, (NW, N, M) in enumerate(zip(n_words.tolist(), n_symbols.tolist(),
                                       n_splits.tolist())):
        index = heuristic.EmissionIndex(kw[b, :NW].numpy(),
                                        yw[b, :NW].numpy().view(np.uint32), W)
        offsets, ks, ys = heuristic.plan_split_offsets(index, N, M,
                                                       window=window)
        found = want[0][b].numpy()
        assert found.sum() == len(offsets)
        assert not found[len(offsets):].any()          # a prefix
        np.testing.assert_array_equal(want[1][b].numpy()[found], offsets)
        np.testing.assert_array_equal(want[2][b].numpy()[found], ks)
        np.testing.assert_array_equal(
            want[3][b].numpy()[found].view(np.uint32), ys)
    cover = rans_encode.plan_cover(kw, last, n_words)
    _assert_cover_identities(kw, last, n_words, cover)
    rounds = won_rounds(want[1], want[0], cover, csum, n_words, n_symbols,
                        n_splits, window=window)
    assert torch.equal(rounds >= 0, want[0])
    return want, rounds


@pytest.mark.parametrize("window", [96, 2, 1])
@pytest.mark.parametrize("ways", [8, 32, 64, 128])
@in_child
def test_plan_decomposition_equals_plain_and_heuristic(ways, window):
    """The cover pass and the chain over (k_of_word, c) pick the oracle's
    slot in every round budget the window leaves, at W 8 to 128 (about
    8 W symbols a split, so that narrow windows still find covered
    words)."""
    from torch_checks import plan_inputs
    n_splits = 16_000 // (8 * ways)
    args, yw = plan_inputs([_symbols(ways + window, 16_000)], ways,
                           [n_splits], "cpu")
    plan, _ = _assert_plans_agree(args, yw, window, n_splits - 1)
    assert int(plan[0].sum()) > n_splits // 2


@in_child
def test_plan_decomposition_wins_later_rounds():
    """At window 2 (seed 3, lambda 100, W 32, 2176 splits) planning stops
    after 198 slots, and five of them are won in a round after the first:
    the path through the lazy rounds, which the window-96 cases never
    take."""
    from torch_checks import plan_inputs
    rng = np.random.default_rng(3)
    syms = np.minimum(rng.exponential(100.0, size=200_000).astype(np.int64),
                      255)
    args, yw = plan_inputs([syms], 32, [2_176], "cpu")
    plan, rounds = _assert_plans_agree(args, yw, 2, 2_175)
    assert int(plan[0].sum()) == 198
    assert int((rounds > 0).sum()) == 5


@in_child
def test_plan_decomposition_ragged_batch():
    """Three contents in one call, as ``ingest_batch`` launches them: one
    with a single split (no slot), one too short to emit a word
    (n_words 0), and one whose 40 splits leave slots past the first's
    M - 1 = 0 and the batch's n_slots past its own."""
    import torch
    from torch_checks import plan_inputs
    contents = [_symbols(31, 5_000), _symbols(32, 9), _symbols(33, 20_011)]
    args, yw = plan_inputs(contents, 32, [1, 7, 40], "cpu")
    assert args[4].tolist()[1] == 0
    plan, _ = _assert_plans_agree(args, yw, 96, 45)
    assert plan[0].sum(1).tolist() == [0, 0, 39]
    assert torch.equal(plan[1][2, 39:], torch.full((6,), -1,
                                                    dtype=torch.int32))

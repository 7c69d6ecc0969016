"""The Hopper kernels against their plain torch versions, on the card: the
walk kernels, the ingest kernels, both paths through DecodeService, and
the LM's serving loop and Recoil checkpoint against the CPU path.

Marked ``cuda``: each test takes the ``cuda_device`` fixture, which skips
when no CUDA device is present (decided inside the fixture, never while the
module is imported).  Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Content is made from a seed with numpy and encoded by the port's host
encoder.  Comparisons are equality (integer codec).  Each test runs in a
child pytest process (``test_torch_isolation.in_child``), and torch and the
port are imported inside the fixture and tests, so the test worker itself
never loads torch.
"""

import glob
import os

import numpy as np
import pytest
from test_torch_isolation import in_child, in_child_process

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not in_child_process():
        return None     # the worker only reports the child's outcome
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.rans_decode.rans_decode import load_library
    load_library()
    return torch.device("cuda", torch.cuda.current_device())


def _int16(words, device, pad=0):
    """16-bit words as the int16 bit patterns the kernels take, with ``pad``
    zero words appended (never read by a valid walk)."""
    import torch
    a = np.concatenate([np.asarray(words, np.uint16),
                        np.zeros(pad, np.uint16)])
    return torch.as_tensor(a.view(np.int16), device=device)


def _content(seed, n, ways, n_bits, n_splits):
    from repro_torch.core import recoil
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)
    model = StaticModel.from_symbols(
        np.concatenate([syms, np.arange(256)]), 256,
        RansParams(n_bits=n_bits, ways=ways))
    enc = encode_interleaved_fast(syms, model)
    plan = recoil.plan_splits(enc, n_splits)
    batch = WalkBatch.from_splits(
        recoil.build_split_states(plan, enc.final_states), ways)
    return syms, model, enc, batch


@pytest.mark.parametrize("ways", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("n_bits", [11, 16])
@in_child
def test_kernels_equal_plain(cuda_device, ways, n_bits):
    import torch
    from repro_torch.core.engine import (SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS,
                                         pad_split_arrays)
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl,
                                             words_by_symbol_host)
    from repro_torch.kernels.rans_decode.ops import _luts, packed_lut_ok
    from repro_torch.kernels.rans_decode.rans_decode import (
        walk_decode_pointer, walk_decode_symbol)
    syms, model, enc, batch = _content(ways + n_bits, 20_000, ways, n_bits,
                                       37)
    n = len(syms)
    dev = cuda_device
    arrs = pad_split_arrays(batch, batch.k.shape[0], dev)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=batch.n_steps,
                   n_symbols=n)
    words = _int16(enc.stream, dev)
    wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
    by = _int16(wbs, dev, (-n) % ways)
    for packed in sorted({False, packed_lut_ok(model)}):
        luts = _luts(model, packed, dev)
        ptr_args = (words, *luts, *(arrs[f] for f in SPLIT_FIELDS))
        out, qf = walk_decode_pointer(*ptr_args, **statics)
        ref_out, ref_qf = _walk_batch_impl(*ptr_args, **statics)
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out) and torch.equal(qf, ref_qf)
        assert (out.cpu().numpy() == syms).all()
        sym_args = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
        out = walk_decode_symbol(*sym_args, **statics)
        ref = _walk_batch_symbol_impl(*sym_args, **statics)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert (out.cpu().numpy() == syms).all()


@pytest.mark.parametrize("ways", [8, 32, 128])
@pytest.mark.parametrize("n_bits", [11, 16])
@in_child
def test_kernels_cross_ring_refills_and_reach_word_0(cuda_device, ways,
                                                     n_bits):
    """Few long splits (hundreds of ring refills each), streams whose length
    is not a multiple of 8, the bottom split reading down to word 0, and
    inert padding rows (``start = -1``) under ``covered``: equal to the
    plain walks."""
    import torch
    from repro_torch.core.engine import (SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS,
                                         kept_windows_tile, pad_split_arrays)
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl,
                                             words_by_symbol_host)
    from repro_torch.kernels.rans_decode.ops import _luts, packed_lut_ok
    from repro_torch.kernels.rans_decode.rans_decode import (
        walk_decode_pointer, walk_decode_symbol)
    syms, model, enc, batch = _content(ways * 7 + n_bits, 60_000, ways,
                                       n_bits, 3)
    n = len(syms)
    dev = cuda_device
    S = batch.k.shape[0]
    assert kept_windows_tile(batch, n)
    arrs = pad_split_arrays(batch, S + 5, dev)
    statics = dict(n_bits=n_bits, ways=ways, n_steps=batch.n_steps,
                   n_symbols=n)
    wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
    for packed in sorted({False, packed_lut_ok(model)}):
        luts = _luts(model, packed, dev)
        for pad in (0, 1, 3, 8):
            words = _int16(enc.stream, dev, pad)
            a = (words, *luts, *(arrs[f] for f in SPLIT_FIELDS))
            out, qf = walk_decode_pointer(*a, **statics, covered=True)
            ref_out, ref_qf = _walk_batch_impl(*a, **statics)
            torch.cuda.synchronize()
            assert int(ref_qf.min()) == -1        # read down to word 0
            assert torch.equal(out, ref_out) and torch.equal(qf, ref_qf)
        by = _int16(wbs, dev, (-n) % ways + 3 * ways)
        a = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
        out = walk_decode_symbol(*a, **statics, covered=True)
        ref = _walk_batch_symbol_impl(*a, **statics)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        assert (out.cpu().numpy() == syms).all()


@in_child
def test_wrapper_rejects_bad_tensors(cuda_device):
    import torch
    from repro_torch.core.engine import SPLIT_FIELDS, pad_split_arrays
    from repro_torch.kernels.rans_decode.ops import _luts
    from repro_torch.kernels.rans_decode.rans_decode import walk_decode_pointer
    syms, model, enc, batch = _content(1, 4_000, 32, 11, 5)
    arrs = pad_split_arrays(batch, batch.k.shape[0], cuda_device)
    words = _int16(enc.stream, cuda_device)
    args = [words, *_luts(model, True, cuda_device),
            *(arrs[f] for f in SPLIT_FIELDS)]
    statics = dict(n_bits=11, ways=32, n_steps=batch.n_steps,
                   n_symbols=len(syms))
    bad = list(args)
    bad[4] = bad[4].to(torch.int64)          # k
    with pytest.raises(ValueError):
        walk_decode_pointer(*bad, **statics)
    with pytest.raises(ValueError):
        walk_decode_pointer(*args, **{**statics, "ways": 48})
    bad = list(args)
    bad[0] = words.to(torch.int32)           # 16-bit words only
    with pytest.raises(ValueError, match="int16"):
        walk_decode_pointer(*bad, **statics)
    bad[0] = words[1:]                       # not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        walk_decode_pointer(*bad, **statics)


@pytest.mark.parametrize("ways", [8, 16, 32, 64, 128])
@in_child
def test_kernels_at_every_rows_per_block_equal_plain(cuda_device, ways):
    """Both walks at every block size their W allows (``rows_per_block``
    warps, at least one whole split a block) equal the plain walks and the
    default launch, on split counts that leave the last block partly
    filled (and one split alone in a block), both slot tables."""
    import torch
    from repro_torch.core.engine import (SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS,
                                         pad_split_arrays)
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl,
                                             words_by_symbol_host)
    from repro_torch.kernels.rans_decode.ops import _luts, packed_lut_ok
    from repro_torch.kernels.rans_decode.rans_decode import (
        ROWS_PER_BLOCK, walk_decode_pointer, walk_decode_symbol)
    dev = cuda_device
    allowed = [r for r in ROWS_PER_BLOCK if 32 * r >= ways]
    launched = 0
    for n_splits in (1, 37, 261):
        syms, model, enc, batch = _content(ways * 3 + n_splits, 30_000,
                                           ways, 11, n_splits)
        n = len(syms)
        S = batch.k.shape[0]
        arrs = pad_split_arrays(batch, S, dev)
        st = dict(n_bits=11, ways=ways, n_steps=batch.n_steps, n_symbols=n)
        words = _int16(enc.stream, dev)
        wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
        by = _int16(wbs, dev, (-n) % ways)
        for packed in sorted({False, packed_lut_ok(model)}):
            luts = _luts(model, packed, dev)
            pa = (words, *luts, *(arrs[f] for f in SPLIT_FIELDS))
            sa = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
            ref_out, ref_qf = _walk_batch_impl(*pa, **st)
            ref_sym = _walk_batch_symbol_impl(*sa, **st)
            base_out, base_qf = walk_decode_pointer(*pa, **st)
            base_sym = walk_decode_symbol(*sa, **st)
            for rpb in allowed:
                out, qf = walk_decode_pointer(*pa, **st, rows_per_block=rpb)
                sym = walk_decode_symbol(*sa, **st, rows_per_block=rpb)
                torch.cuda.synchronize()
                assert torch.equal(out, ref_out), (rpb, n_splits, packed)
                assert torch.equal(qf, ref_qf), (rpb, n_splits, packed)
                assert torch.equal(sym, ref_sym), (rpb, n_splits, packed)
                assert torch.equal(out, base_out) and \
                    torch.equal(qf, base_qf) and torch.equal(sym, base_sym)
                launched += 1
            assert (ref_out.cpu().numpy() == syms).all()
    assert launched >= 3 * len(allowed)


@in_child
def test_bad_rows_per_block_raises_before_any_launch(cuda_device):
    import torch
    from repro_torch.core.engine import (DecoderSession, SPLIT_FIELDS,
                                         pad_split_arrays)
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.kernels.rans_decode.ops import _luts
    syms, model, enc, batch = _content(2, 4_000, 64, 11, 5)
    arrs = pad_split_arrays(batch, batch.k.shape[0], cuda_device)
    args = [_int16(enc.stream, cuda_device), *_luts(model, True, cuda_device),
            *(arrs[f] for f in SPLIT_FIELDS)]
    statics = dict(n_bits=11, ways=64, n_steps=batch.n_steps,
                   n_symbols=len(syms))
    rd.reset_counts()
    for bad in (0, 3, 64, -4, True, 8.0, "8", 1):   # 1 warp < one W=64 split
        with pytest.raises(ValueError, match="rows_per_block"):
            rd.walk_decode_pointer(*args, **statics, rows_per_block=bad)
        with pytest.raises(ValueError, match="rows_per_block"):
            DecoderSession(model, device=cuda_device, rows_per_block=bad)
    torch.cuda.synchronize()
    assert rd.walk_decode_pointer.launches == 0
    assert rd.walk_decode_symbol.launches == 0


@in_child
def test_autotuner_on_the_card_writes_a_cuda_profile(cuda_device, tmp_path,
                                                     monkeypatch):
    from repro_torch.core.tuning import Autotuner, TuningDB
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    db_path = tmp_path / "tuning.json"
    kw = dict(device=cuda_device, repeats=3, max_probes=3, n_splits=64)
    t1 = Autotuner(**kw)
    prof = t1.tune([20_000, 60_000], db_path=db_path, max_batch=4)
    assert t1.measurements > 0 and prof.measurements == t1.measurements
    assert prof.key == "cuda:cuda:auto"
    assert TuningDB.load(db_path).get("cuda:cuda:auto") == prof
    sweep = prof.meta["rows_per_block_sweep"]
    assert sweep["timed"] is True
    assert {k: v["valid"] for k, v in sweep["candidates"].items()} == \
        {"4": True, "8": True, "16": True}
    assert prof.rows_per_block in (4, 8, 16)
    t2 = Autotuner(**kw)
    assert t2.tune([20_000, 60_000], db_path=db_path, max_batch=4) == prof
    assert t2.measurements == 0
    assert not (tmp_path / "cache").exists()


@in_child
def test_service_decodes_through_the_kernels(cuda_device):
    """Both layouts through DecodeService on the card: outputs equal the
    input symbols and only kernel launches served them."""
    import torch
    from repro_torch.core import recoil
    from repro_torch.core.vectorized import encode_interleaved_fast
    from repro_torch.kernels.rans_decode.rans_decode import (
        walk_decode_pointer, walk_decode_symbol)
    from repro_torch.runtime.serve import DecodeService
    syms_a, model, enc_a, _ = _content(7, 30_000, 32, 11, 64)
    rng = np.random.default_rng(8)
    syms_b = np.minimum(rng.exponential(40.0, 25_000).astype(np.int64), 255)
    enc_b = encode_interleaved_fast(syms_b, model)
    svc = DecodeService(model, device=cuda_device)
    svc.register("a", recoil.plan_splits(enc_a, 64), enc_a.stream,
                 enc_a.final_states, emission_log=enc_a.k_of_word)
    svc.register("b", recoil.plan_splits(enc_b, 64), enc_b.stream,
                 enc_b.final_states)
    assert (svc.layout_for("a"), svc.layout_for("b")) == ("symbol", "pointer")
    p0, s0 = walk_decode_pointer.launches, walk_decode_symbol.launches
    plain0 = walk_decode_pointer.plain_calls + walk_decode_symbol.plain_calls
    for th in (1, 16, 64):
        assert (svc.decode("a", th).cpu().numpy() == syms_a).all()
        assert (svc.decode("b", th).cpu().numpy() == syms_b).all()
    reqs = [("a", 8), ("b", 8), ("a", 16), ("b", 3)]
    tickets = [svc.submit(nm, th) for nm, th in reqs]
    svc.flush()
    for (nm, _), t in zip(reqs, tickets):
        want = syms_a if nm == "a" else syms_b
        assert (t.result().cpu().numpy() == want).all()
    assert walk_decode_symbol.launches - s0 == 3
    assert walk_decode_pointer.launches - p0 == 4
    assert walk_decode_pointer.plain_calls + \
        walk_decode_symbol.plain_calls == plain0
    assert svc.content("a").stream.words.dtype == torch.int16
    assert svc.content("a").stream.by_symbol.dtype == torch.int16


@in_child
def test_session_defaults_to_the_kernels(cuda_device):
    from repro_torch.core import recoil
    from repro_torch.core.engine import DecoderSession
    syms, model, enc, _ = _content(3, 10_000, 32, 11, 8)
    sess = DecoderSession(model)
    assert sess.impl == "cuda" and sess.device.type == "cuda"
    out = sess.decode(recoil.plan_splits(enc, 8), enc.stream,
                      enc.final_states)
    assert (out.cpu().numpy() == syms).all()
    with pytest.raises(ValueError):
        DecoderSession(model, impl="torch")


@in_child
def test_decode_spans_nest_to_the_allocation_on_the_card(cuda_device):
    """Under a CPU and CUDA profiler a card decode opens ``recoil.decode``
    > ``recoil.execute`` > ``recoil.walk.launch`` > ``recoil.walk.alloc``
    on one thread; a range leaves no event on the device's timeline, and
    the walk kernel is not a ``recoil.`` name."""
    import torch
    from repro_torch.core import recoil
    from repro_torch.runtime.serve import DecodeService
    syms, model, enc, _ = _content(9, 30_000, 32, 11, 64)
    svc = DecodeService(model, device=cuda_device)
    svc.register("a", recoil.plan_splits(enc, 64), enc.stream,
                 enc.final_states)
    plain = svc.decode("a", 16).cpu()
    assert (plain.numpy() == syms).all()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = svc.decode("a", 16)
        torch.cuda.synchronize()
    assert torch.equal(out.cpu(), plain)
    host, shadows, kernels = [], [], []
    for ev in prof.events():
        on_card = str(ev.device_type).endswith("CUDA")
        if ev.name.startswith("recoil.") and not on_card:
            host.append((ev.time_range.start, ev.time_range.end, ev.name,
                         ev.thread))
        elif ev.name.startswith("recoil."):
            shadows.append(ev)
        elif on_card:
            kernels.append(ev.name)
    host = sorted(r for r in host if r[2] != "recoil.gc")
    assert [r[2] for r in host] == ["recoil.decode", "recoil.execute",
                                    "recoil.walk.launch", "recoil.walk.alloc"]
    assert len({r[3] for r in host}) == 1
    for outer, inner in zip(host, host[1:]):
        assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert not shadows
    assert any("walk_" in k for k in kernels)


@in_child
def test_plans_of_one_key_decode_their_own_sizes(cuda_device):
    """Two requests that share a plan key (one launcher) but differ in
    n_symbols: each output has its own length and equals its symbols."""
    from repro_torch.core import recoil
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    syms, model, _, _ = _content(21, 3_000, 32, 11, 8)
    sess = DecoderSession(model)

    def prepare(n):
        e = encode_interleaved_fast(syms[:n], model)
        rp = recoil.plan_splits(e, 8)
        batch = WalkBatch.from_splits(
            recoil.build_split_states(rp, e.final_states), 32)
        return sess.prepare(batch, e.stream, n)

    first = prepare(3_000)
    second = next(p for p in map(prepare, range(2_990, 2_700, -10))
                  if p.key == first.key)
    for plan in (first, second):
        assert plan.covered
        out = sess.execute(plan)
        assert out.shape == (plan.n_symbols,)
        assert (out.cpu().numpy() == syms[:plan.n_symbols]).all()
    assert (sess.stats.compiles, sess.stats.cache_hits) == (1, 1)


# ---------------------------------------------------------------------------
# Walk coverage: other quantizations, 16-bit symbols, the conventional
# adapter and the golden vectors, each through the card's session
# ---------------------------------------------------------------------------

def _session_walk_equals_plain(sess, batch, stream, n_symbols, want):
    """The executor's call on the card for one request, one kernel launch,
    held against the plain walk of its layout on the same arguments (output
    and, pointer, final pointers) and against the symbols it must decode;
    returns the layout."""
    import torch
    from torch_checks import session_walk

    from repro_torch.kernels.rans_decode import rans_decode as rd
    launches = rd.walk_decode_pointer.launches + rd.walk_decode_symbol.launches
    layout, pairs = session_walk(sess, batch, stream, n_symbols)
    torch.cuda.synchronize()
    assert rd.walk_decode_pointer.launches + \
        rd.walk_decode_symbol.launches == launches + 1
    for got, ref in pairs:
        assert torch.equal(got, ref)
    np.testing.assert_array_equal(pairs[0][0].cpu().numpy(), want)
    return layout


def _check_walk_layouts(syms, model, n_splits, device):
    """Both walks, under every slot-table layout the model allows, through a
    session on the card, against their plain versions."""
    from repro_torch.core import recoil
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    from repro_torch.kernels.rans_decode.ops import packed_lut_ok
    enc = encode_interleaved_fast(syms, model)
    plan = recoil.plan_splits(enc, n_splits)
    batch = WalkBatch.from_splits(
        recoil.build_split_states(plan, enc.final_states), model.params.ways)
    n = len(syms)
    for packed in sorted({False, packed_lut_ok(model)}):
        sess = DecoderSession(model, device=device, packed_lut=packed)
        ds = sess.upload_stream(enc.stream)
        assert _session_walk_equals_plain(sess, batch, ds, n, syms) == \
            "pointer"
        ds = with_symbol_layout(ds, enc.k_of_word, n)
        assert _session_walk_equals_plain(sess, batch, ds, n, syms) == \
            "symbol"


@pytest.mark.parametrize("ways", [8, 32, 128])
@pytest.mark.parametrize("n_bits", [8, 14])
@in_child
def test_walk_kernels_at_n_bits_8_and_14(cuda_device, ways, n_bits):
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(ways * 10 + n_bits)
    syms = np.minimum(rng.exponential(40.0, size=20_000).astype(np.int64),
                      255)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]),
                                     256, RansParams(n_bits=n_bits, ways=ways))
    _check_walk_layouts(syms, model, 37, cuda_device)


@in_child
def test_walk_kernels_on_a_4096_symbol_alphabet(cuda_device):
    """16-bit symbols at n = 14: the three-table slot layout only."""
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.kernels.rans_decode.ops import packed_lut_ok
    rng = np.random.default_rng(5)
    syms = rng.integers(0, 4096, size=20_000)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(4096)]),
                                     4096, RansParams(n_bits=14, ways=32))
    assert not packed_lut_ok(model)
    _check_walk_layouts(syms, model, 24, cuda_device)


@in_child
def test_decode_conventional_on_the_card(cuda_device):
    """``DecoderSession.decode_conventional`` on the card (pointer walk: a
    conventional stream has no emission log): its executor call equals the
    plain walk, and the session's decode equals the symbols and the CPU
    session's."""
    from repro_torch.core import conventional
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.vectorized import WalkBatch
    from repro_torch.kernels.rans_decode import rans_decode as rd
    syms, model, _, _ = _content(17, 30_000, 32, 11, 1)
    conv = conventional.encode_conventional(syms, model, 9)
    sess = DecoderSession(model, device=cuda_device)
    states, words, out_bases = conventional.to_split_states(conv)
    batch = WalkBatch.from_splits(states, 32, out_bases)
    assert _session_walk_equals_plain(sess, batch, words, conv.n_symbols,
                                      syms) == "pointer"
    before = rd.walk_decode_pointer.launches
    out = sess.decode_conventional(conv).cpu().numpy()
    assert rd.walk_decode_pointer.launches == before + 1
    np.testing.assert_array_equal(out, syms)
    cpu = DecoderSession(model, device="cpu").decode_conventional(conv)
    np.testing.assert_array_equal(out, cpu.numpy())


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NAMES = sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(GOLDEN, "*.bin")))


@pytest.mark.parametrize("name", GOLDEN_NAMES)
@in_child
def test_golden_vectors_on_the_card(cuda_device, name):
    """The frozen wire containers of ``tests/golden`` parsed by the port and
    decoded on the card under both layouts (the symbol layout from the
    frozen emission log): each executor call equals its plain walk, and
    each decode the frozen symbols."""
    from repro_torch.core import container, recoil
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    from repro_torch.core.rans import RansParams
    from repro_torch.core.vectorized import WalkBatch
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as f:
        buf = f.read()
    npz = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    parsed = container.parse(buf, RansParams(n_bits=int(npz["n_bits"]),
                                             ways=int(npz["ways"])))
    syms = npz["symbols"]
    n = len(syms)
    batch = WalkBatch.from_splits(
        recoil.build_split_states(parsed.plan, parsed.final_states),
        parsed.plan.ways)
    sess = DecoderSession(parsed.model, device=cuda_device)
    ds = sess.upload_stream(parsed.stream)
    for layout in ("pointer", "symbol"):
        if layout == "symbol":
            ds = with_symbol_layout(ds, npz["k_of_word"], n)
        assert _session_walk_equals_plain(sess, batch, ds, n, syms) == layout
        out = sess.decode(parsed.plan, ds, parsed.final_states)
        np.testing.assert_array_equal(out.cpu().numpy(), syms)


# ---------------------------------------------------------------------------
# The ingest kernels (kernels/rans_encode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ways", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("n_bits", [11, 12, 16])
@in_child
def test_encode_kernel_equals_plain(cuda_device, ways, n_bits):
    """Lengths off a multiple of W and under W, resume lead slots and a
    random x0: every output of the kernel equals the plain version's."""
    import torch
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.encode.executors import encode_scan_args
    from repro_torch.kernels.rans_encode import rans_encode as re_
    rng = np.random.default_rng(ways * 100 + n_bits)
    for n, head in ((5, 0), (3_001, 3_001 % ways), (ways * 40, ways - 1)):
        syms = np.minimum(rng.exponential(30.0, size=n).astype(np.int64),
                          255)
        model = StaticModel.from_symbols(
            np.concatenate([syms, np.arange(256)]), 256,
            RansParams(n_bits=n_bits, ways=ways))
        x0 = rng.integers(1 << 16, 1 << 32, size=ways,
                          dtype=np.uint64).astype(np.uint32)
        args = encode_scan_args(syms, model.f, model.F, ways, cuda_device,
                                head=head, x0=x0)
        before = re_.encode_scan.launches
        got = re_.encode_scan(*args, n_bits=n_bits)
        want = re_.encode_scan_plain(*args, n_bits=n_bits)
        assert re_.encode_scan.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert not bool(got[4][0])


@in_child
def test_encode_kernel_adaptive_wide_alphabet_and_zero_freq(cuda_device):
    import torch
    from repro_torch.core.adaptive import ContextModel
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.encode.executors import encode_scan_args
    from repro_torch.kernels.rans_encode import rans_encode as re_
    rng = np.random.default_rng(3)
    n = 9_003
    ctx = (np.arange(n) % 4).astype(np.int32)
    cm = ContextModel.from_scale_table([3.0, 8.0, 20.0, 60.0], ctx, 256,
                                       RansParams(n_bits=11, ways=32))
    syms = np.minimum(rng.exponential(30.0, size=n).astype(np.int64), 255)
    wide = rng.integers(0, 4096, size=20_000)
    m12 = StaticModel.from_symbols(np.concatenate([wide, np.arange(4096)]),
                                   4096, RansParams(n_bits=12, ways=32))
    skew = np.minimum(rng.exponential(3.0, size=2_000).astype(np.int64), 255)
    mz = StaticModel.from_symbols(skew, 256, RansParams(n_bits=11, ways=32))
    bad = skew.copy()
    bad[777] = 250
    assert mz.f[250] == 0
    for args, n_bits, flagged in (
            (encode_scan_args(syms, cm.f, cm.F, 32, cuda_device, ctx=ctx),
             11, False),
            (encode_scan_args(wide, m12.f, m12.F, 32, cuda_device), 12,
             False),
            (encode_scan_args(bad, mz.f, mz.F, 32, cuda_device), 11,
             True)):
        got = re_.encode_scan(*args, n_bits=n_bits)
        want = re_.encode_scan_plain(*args, n_bits=n_bits)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert bool(got[4][0]) is flagged


def _assert_encode_equals_plain(args, n_bits, flags, table=None):
    import torch
    from repro_torch.kernels.rans_encode import rans_encode as re_
    before = re_.encode_scan.launches
    got = re_.encode_scan(*args, n_bits=n_bits, table=table)
    want = re_.encode_scan_plain(*args, n_bits=n_bits)
    assert re_.encode_scan.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[4].tolist() == flags


@pytest.mark.parametrize("G", [1, 7, 8, 9, 63, 64, 65, 129, 257])
@in_child
def test_encode_kernel_group_counts_around_the_chunk(cuda_device, G):
    """Group counts under, at and past the kernel's 64-group chunk and its
    4-stage ring, with lead slots and a random x0."""
    from repro_torch.core.encode.executors import encode_scan_args
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(G)
    syms = np.minimum(rng.exponential(30.0, size=G * 32 - 5).astype(
        np.int64), 255)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]),
                                     256, RansParams(n_bits=11, ways=32))
    x0 = rng.integers(1 << 16, 1 << 32, size=32, dtype=np.uint64).astype(
        np.uint32)
    args = encode_scan_args(syms, model.f, model.F, 32, cuda_device, head=3,
                            x0=x0)
    assert args[0].shape[1] == G
    _assert_encode_equals_plain(args, 11, [False])


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("ways", [8, 128])
@in_child
def test_encode_kernel_ragged_batches(cuda_device, ways, adaptive):
    """Five ragged contents in one launch (several to a block at W = 8,
    one over four blocks at W = 128), resumed from a random x0; the static
    batch's fourth content opens with a zero-frequency symbol in a way
    whose state starts at 0, which must emit and flag that content only."""
    import torch
    from repro_torch.core.adaptive import ContextModel
    from repro_torch.core.encode.executors import scan_grids
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(ways + adaptive)
    lens, heads = (3_001, 17, ways * 10, 999, 2), (0, 5, ways - 1, 0, 1)
    syms = [np.minimum(rng.exponential(3.0, size=n).astype(np.int64), 255)
            for n in lens]
    params = RansParams(n_bits=11, ways=ways)
    if adaptive:
        model = ContextModel.from_scale_table(
            [3.0, 8.0, 20.0], np.zeros(1, np.int32), 256, params)
        ctxs = [(np.arange(n) % 3).astype(np.int32) for n in lens]
        flags = [False] * 5
    else:
        model = StaticModel.from_symbols(np.concatenate(syms), 256, params)
        syms[3][0] = int(np.flatnonzero(model.f == 0)[0])
        ctxs = [None] * 5
        flags = [False, False, False, True, False]
    x0 = rng.integers(1 << 16, 1 << 32, size=(5, ways),
                      dtype=np.uint64).astype(np.uint32)
    x0[3, 0] = 0
    dev = cuda_device
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        a.astype(np.int32), device=dev)
    sym, active, ctx, x0_t = scan_grids(
        [(h, t(s), t(c)) for h, s, c in zip(heads, syms, ctxs)], ways, dev,
        adaptive, torch.as_tensor(x0.view(np.int32), device=dev))
    f, F = (torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
            for a in (model.f, model.F))
    args = (sym, active, f, F, x0_t) + ((ctx,) if adaptive else ())
    _assert_encode_equals_plain(args, 11, flags)


@pytest.mark.parametrize("alphabet,n_bits", [(4096, 12), (5000, 13)])
@in_child
def test_encode_kernel_wide_alphabets(cuda_device, alphabet, n_bits):
    """4096 symbols: the table staged in over 48 KB of shared memory;
    5000: read through the read-only data cache.  Resumed from a random
    x0 behind lead slots."""
    from repro_torch.core.encode.executors import encode_scan_args
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(alphabet)
    syms = rng.integers(0, alphabet, size=20_000)
    model = StaticModel.from_symbols(
        np.concatenate([syms, np.arange(alphabet)]), alphabet,
        RansParams(n_bits=n_bits, ways=32))
    x0 = rng.integers(1 << 16, 1 << 32, size=32, dtype=np.uint64).astype(
        np.uint32)
    args = encode_scan_args(syms, model.f, model.F, 32, cuda_device,
                            head=7, x0=x0)
    _assert_encode_equals_plain(args, n_bits, [False])


@in_child
def test_encode_wrapper_refuses_a_table_for_another_n_bits(cuda_device):
    """The caller's table is used as given, and one built for another
    n_bits raises before any launch."""
    from repro_torch.core.encode.executors import encode_scan_args
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.kernels.rans_encode import rans_encode as re_
    rng = np.random.default_rng(5)
    syms = np.minimum(rng.exponential(30.0, size=3_000).astype(np.int64),
                      255)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]),
                                     256, RansParams(n_bits=11, ways=32))
    args = encode_scan_args(syms, model.f, model.F, 32, cuda_device)
    _assert_encode_equals_plain(args, 11, [False],
                                table=re_.encoder_table(args[2], args[3], 11))
    before = re_.encode_scan.launches
    with pytest.raises(ValueError, match="n_bits"):
        re_.encode_scan(*args, n_bits=11,
                        table=re_.encoder_table(args[2], args[3], 12))
    assert re_.encode_scan.launches == before


@in_child
def test_plan_kernel_equals_plain_and_heuristic(cuda_device):
    """The planner's kernels against the plain versions and the port's
    ``heuristic.plan_split_offsets`` on the same emission data: a case that
    needs window expansion, a 2176-thread plan, a window-2 case whose slots
    are won in later rounds, and a ragged batch of three contents (one
    split; no word; slots past a content's M - 1).  The cover kernel alone
    equals ``plan_cover_plain`` on every word."""
    import torch
    from torch_checks import plan_inputs, won_rounds

    from repro_torch.core import heuristic
    from repro_torch.kernels.rans_encode import rans_encode as re_

    def expo(seed, n, lam=40.0):
        rng = np.random.default_rng(seed)
        return np.minimum(rng.exponential(lam, size=n).astype(np.int64), 255)

    cases = (([expo(2, 4_000, 2.0)], 32, [100], 96),
             ([expo(5, 30_000)], 64, [2_176], 96),
             ([expo(6, 20_011)], 8, [16], 96),
             ([expo(3, 200_000, 100.0)], 32, [2_176], 2),
             ([expo(31, 5_000), expo(32, 9), expo(33, 20_011)], 32,
              [1, 7, 40], 96))
    later = 0
    for i, (contents, ways, n_splits, window) in enumerate(cases):
        args, yw = plan_inputs(contents, ways, n_splits, cuda_device)
        kw, csum, last, _, n_words, n_symbols, m = args
        kw_args = dict(window=window, n_slots=max(n_splits) - 1 + 5)
        before = re_.plan_splits.launches
        got = re_.plan_splits(*args, **kw_args)
        assert re_.plan_splits.launches == before + 1
        want = re_.plan_splits_plain(*args, **kw_args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if i == 0:      # the trigger: slot 97 of 99 runs every round and
            assert int(got[0].sum()) == 97      # finds no candidate
        cover = re_.plan_cover(kw, last, n_words)
        assert torch.equal(cover, re_.plan_cover_plain(kw, last, n_words))
        rounds = won_rounds(*(t.cpu() for t in (got[1], got[0], cover, csum,
                                                n_words, n_symbols, m)),
                            window=window)
        later += int((rounds > 0).sum())
        for b, (NW, N, M) in enumerate(zip(n_words.tolist(),
                                           n_symbols.tolist(), m.tolist())):
            index = heuristic.EmissionIndex(
                kw[b, :NW].cpu().numpy(),
                yw[b, :NW].cpu().numpy().view(np.uint32), ways)
            offsets, ks, ys_h = heuristic.plan_split_offsets(
                index, N, M, window=window)
            found = got[0][b].cpu().numpy()
            assert found.sum() == len(offsets)
            np.testing.assert_array_equal(got[1][b].cpu().numpy()[found],
                                          offsets)
            np.testing.assert_array_equal(got[2][b].cpu().numpy()[found], ks)
            np.testing.assert_array_equal(
                got[3][b].cpu().numpy()[found].view(np.uint32), ys_h)
    assert later > 0


@in_child
def test_ingest_round_trip_on_the_card(cuda_device):
    """DecodeService on the card: ingest, extend and ingest_batch run both
    ingest kernels and no plain version, equal the CPU session's results,
    and decode to the input symbols."""
    import torch
    from repro_torch.core.encode import EncoderSession
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.kernels.rans_encode import rans_encode as re_
    from repro_torch.runtime.serve import DecodeService
    rng = np.random.default_rng(13)
    syms = np.minimum(rng.exponential(40.0, size=50_001).astype(np.int64),
                      255)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]),
                                     256, RansParams(n_bits=11, ways=32))
    svc = DecodeService(model)
    cpu = EncoderSession(model, device="cpu")
    re_.reset_counts()
    svc.ingest("a", syms[:45_003], 64)
    assert svc.layout_for("a") == "symbol"
    assert (svc.decode("a", 16).cpu().numpy() == syms[:45_003]).all()
    svc.extend("a", syms[45_003:])
    assert (svc.decode("a", 64).cpu().numpy() == syms).all()
    svc.ingest_batch({"b": syms[:7_000], "c": syms[100:20_000]}, 8)
    assert (svc.decode("c", 8).cpu().numpy() == syms[100:20_000]).all()
    assert re_.encode_scan.launches == 3 and re_.plan_splits.launches == 3
    assert re_.encode_scan.plain_calls == re_.plan_splits.plain_calls == 0
    on_card = svc.content("b")
    want = cpu.ingest(syms[:7_000], 8)
    assert torch.equal(on_card.stream.words.cpu(), want.stream.words)
    assert torch.equal(on_card.stream.by_symbol.cpu(), want.stream.by_symbol)
    assert [p.offset for p in on_card.plan.points] == \
        [p.offset for p in want.plan.points]


# ---------------------------------------------------------------------------
# Chunked streaming decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_chunked_decode_on_the_card(cuda_device, layout):
    """``decode_chunks`` and ``submit_stream`` on the card: each chunk is a
    walk launch whose output equals its slice of the symbols and the plain
    walk's chunk on the CPU; ``synchronize(i)`` waits on chunk i's event;
    the chunks concatenate to ``decode``; a warm stream resolves nothing."""
    import torch
    from repro_torch.core import recoil
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.runtime.serve import DecodeService
    syms, model, enc, _ = _content(41, 60_001, 32, 11, 64)
    plan = recoil.plan_splits(enc, 64)
    log = enc.k_of_word if layout == "symbol" else None
    svc = DecodeService(model)
    cpu = DecodeService(model, device="cpu")
    for s in (svc, cpu):
        s.register("a", plan, enc.stream, enc.final_states, emission_log=log)
    assert svc.layout_for("a") == layout
    kernel = (rd.walk_decode_symbol if layout == "symbol"
              else rd.walk_decode_pointer)
    rd.reset_counts()
    launches = plain_calls = 0
    for th, n_chunks in ((64, 1), (64, 3), (64, 8), (16, 8), (5, 9)):
        parts = svc.decode_chunks("a", th, n_chunks)
        t = svc.submit_stream("a", th, n_chunks)
        plain = cpu.decode_chunks("a", th, n_chunks)
        assert t.n_chunks == len(parts) == len(plain)
        launches += 2 * t.n_chunks
        plain_calls += t.n_chunks         # the CPU service's plain walks
        for i, spec in enumerate(t.specs):
            got = t.synchronize(i)
            assert t._ready[i].query()
            want = syms[spec.base:spec.base + spec.length]
            assert (got.cpu().numpy() == want).all()
            assert torch.equal(parts[i].cpu(), plain[i])
        assert torch.equal(t.result(), svc.decode("a", th))
        launches += 1
        assert all(p.covered for p, _ in svc._chunked_plans("a", th,
                                                            n_chunks))
    assert kernel.launches == launches
    assert kernel.plain_calls == plain_calls and kernel.fills == 0
    compiles = svc.stats.compiles
    svc.submit_stream("a", 64, 8).synchronize(7)
    assert svc.stats.compiles == compiles


@in_child
def test_prefix_upload_on_the_card(cuda_device):
    """A chunk decodes from a stream on the card that holds only its
    ``words_end`` words, at lengths that are not a multiple of 8 (the
    kernel's 16-byte ring copies clamp at the stream's end), equal to its
    symbols and to the plain walk on the same prefix."""
    import torch
    from repro_torch.core.engine import (DecoderSession, DeviceStream,
                                         chunk_walk_batch)
    syms, model, enc, batch = _content(42, 40_000, 32, 11, 24)
    sess = DecoderSession(model)
    cpu = DecoderSession(model, device="cpu")
    specs = chunk_walk_batch(batch, len(syms), 8)
    ends = [s.words_end for s in specs]
    assert any(e % 8 for e in ends), ends
    for spec in specs:
        for n in sorted({spec.words_end,
                         min(spec.words_end + 3, enc.n_words)}):
            host = np.asarray(enc.stream[:n], np.uint16)
            streams = [DeviceStream(
                words=torch.as_tensor(host.view(np.int16), device=d),
                host=host, n_words=n, bucket=n) for d in (cuda_device, "cpu")]
            out = sess.execute(sess.prepare(spec.batch, streams[0],
                                            spec.length))
            ref = cpu.execute(cpu.prepare(spec.batch, streams[1],
                                          spec.length))
            assert torch.equal(out.cpu(), ref)
            assert (ref.numpy() ==
                    syms[spec.base:spec.base + spec.length]).all()


# ---------------------------------------------------------------------------
# The pipeline broker on the card
# ---------------------------------------------------------------------------

def _broker_service(seed, n, n_splits, layout, **kw):
    """A service on the card holding one content on ``layout``: ingested on
    the card (symbol), or encoded on the host and registered without its
    emission log (pointer)."""
    from repro_torch.core import recoil
    from repro_torch.runtime.serve import DecodeService
    syms, model, enc, _ = _content(seed, n, 32, 11, n_splits)
    svc = DecodeService(model, **kw)
    if layout == "symbol":
        svc.ingest("a", syms, n_splits)
    else:
        svc.register("a", recoil.plan_splits(enc, n_splits), enc.stream,
                     enc.final_states)
    assert svc.layout_for("a") == layout
    return syms, model, svc


@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_broker_round_trip_on_the_card(cuda_device, layout):
    """Broker traffic on the card after ``warm``: every result (a device
    tensor the broker has waited for) equals the symbols, the walk kernel
    launched and no plain version served, the requests resolved no launcher
    after ``warm``, and a stream through the broker equals the asset."""
    import torch
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.runtime.pipeline import ControllerConfig
    syms, _, svc = _broker_service(51, 80_001, 64, layout)
    want = torch.as_tensor(syms.astype(np.int32), device=cuda_device)
    kernel = (rd.walk_decode_symbol if layout == "symbol"
              else rd.walk_decode_pointer)
    rd.reset_counts()
    with svc.start_pipeline(config=ControllerConfig(max_batch=4),
                            predictive=False) as b:
        b.warm(["a"], [4, 16, 64])
        compiles = svc.stats.compiles
        tickets = [svc.submit("a", (4, 16, 64)[i % 3],
                              deadline=("interactive", "standard",
                                        "bulk")[i % 3]) for i in range(24)]
        for t in tickets:
            out = t.result(timeout=30)
            assert out.device.type == "cuda"
            assert t.ready is not None and t.ready.query()
            assert torch.equal(out, want)
        assert svc.stats.compiles == compiles
        st = svc.submit_stream("a", 64, n_chunks=4)
        parts = [st.synchronize(i, timeout=30) for i in range(st.n_chunks)]
        assert torch.equal(torch.cat(parts), want)
        b.drain(timeout=30)
        snap = b.snapshot()
    assert snap["completed"] == 25 and snap["dispatch_errors"] == 0
    assert snap["stream_dispatches"] == 1
    assert kernel.launches > 0 and kernel.plain_calls == 0


@in_child
def test_broker_ingest_worker_on_the_card(cuda_device):
    """An ingest and an extend through the broker's ingest worker run both
    ingest kernels (no plain version) and equal the CPU session's results;
    a decode submitted right after each ticket resolves is exact."""
    import torch
    from repro_torch.core.encode import EncoderSession
    from repro_torch.kernels.rans_encode import rans_encode as re_
    syms, model, svc = _broker_service(52, 60_001, 64, "symbol")
    cpu = EncoderSession(model, device="cpu")
    re_.reset_counts()
    with svc.start_pipeline() as b:
        plan = b.submit_ingest("n", syms[:50_000], 64).result(timeout=30)
        assert plan.n_symbols == 50_000
        out = svc.submit("n", 16).result(timeout=30)
        assert (out.cpu().numpy() == syms[:50_000]).all()
        b.submit_extend("n", syms[50_000:]).result(timeout=30)
        out = svc.submit("n", 64).result(timeout=30)
        assert (out.cpu().numpy() == syms).all()
        b.drain(timeout=30)
    assert re_.encode_scan.launches == 2 and re_.plan_splits.launches == 2
    assert re_.encode_scan.plain_calls == re_.plan_splits.plain_calls == 0
    want = cpu.ingest(syms, 64)
    got = svc.content("n")
    assert torch.equal(got.stream.words.cpu(), want.stream.words)
    assert torch.equal(got.stream.by_symbol.cpu(), want.stream.by_symbol)
    assert np.array_equal(got.final_states, want.final_states)


@in_child
def test_broker_retries_an_execute_fault_on_the_card(cuda_device):
    import torch
    from repro_torch.runtime.faultinject import FaultInjector
    inj = FaultInjector()
    syms, _, svc = _broker_service(53, 40_001, 32, "pointer", faults=inj)
    with svc.start_pipeline(retry_backoff_ms=1.0) as b:
        inj.arm("service.execute", times=1)
        out = svc.submit("a", 32, retries=2).result(timeout=30)
        assert torch.equal(out.cpu(), torch.as_tensor(syms.astype(np.int32)))
        b.drain(timeout=30)
        snap = b.snapshot()
        metrics = svc.metrics()
    assert snap["retries"] == 1 and snap["dispatch_errors"] == 1
    assert snap["completed"] == 1
    assert metrics["recoil_broker_retries_total"]["values"][""] == 1


@in_child
def test_broker_waits_are_scoped_to_their_launch(cuda_device):
    """The decode worker's wait is on the event recorded right after its
    group's launch, not on the device: with ``observe=False`` (so the
    dispatch itself does not wait), the group's dispatch lets the ingest
    worker queue about a second of device work (a device sleep ahead of a
    real ingest) on the same stream before the worker waits — and the
    group completes while that later work is still running, its CUDA
    events showing the sleep's length."""
    import threading
    import time
    import torch
    from repro_torch.runtime.pipeline import ControllerConfig
    syms, _, svc = _broker_service(54, 40_001, 32, "symbol", observe=False)
    want = torch.as_tensor(syms.astype(np.int32), device=cuda_device)
    marks, queued = {}, threading.Event()
    ingest, dispatch_group = svc.ingest, svc.dispatch_group

    def long_ingest(name, symbols, n_splits):
        marks["start"] = torch.cuda.Event(enable_timing=True)
        marks["end"] = torch.cuda.Event(enable_timing=True)
        marks["start"].record()
        torch.cuda._sleep(2_000_000_000)      # about 1 s at the SM clock
        marks["end"].record()
        queued.set()
        return ingest(name, symbols, n_splits)

    def dispatch_then_ingest(requests, tickets):
        dispatch_group(requests, tickets)     # launch + readiness event
        b.submit_ingest("later", syms, 32)
        assert queued.wait(30)                # the sleep is queued behind it

    svc.ingest, svc.dispatch_group = long_ingest, dispatch_then_ingest
    b = svc.start_pipeline(config=ControllerConfig(max_batch=1),
                           predictive=False)
    try:
        t0 = time.perf_counter()
        t = svc.submit("a", 32)
        deadline = t0 + 30
        while (b.snapshot()["dispatch_groups"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.001)
        waited = time.perf_counter() - t0
        assert b.snapshot()["dispatch_groups"] == 1
        still_running = not marks["end"].query()
        assert torch.equal(t.result(timeout=30), want)
        b.drain(timeout=60)
    finally:
        svc.stop_pipeline()
        svc.ingest, svc.dispatch_group = ingest, dispatch_group
    sleep_ms = marks["start"].elapsed_time(marks["end"])
    assert still_running, "the decode's wait covered later ingest work"
    assert sleep_ms > 200 and waited * 1e3 < sleep_ms, (waited, sleep_ms)
    assert (svc.decode("later", 32).cpu().numpy() == syms).all()


CUDA_ERROR_AT_THE_WAIT = """
import sys
import numpy as np, torch
from repro_torch.core.rans import RansParams, StaticModel
from repro_torch.runtime.pipeline import ControllerConfig
from repro_torch.runtime.serve import DecodeService
rng = np.random.default_rng(55)
syms = np.minimum(rng.exponential(40.0, size=30_000).astype(np.int64), 255)
model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]), 256,
                                 RansParams(n_bits=11, ways=32))
svc = DecodeService(model, observe=sys.argv[1] == "observe")
svc.ingest("a", syms, 16)
execute = svc.session.execute

def faulting(plan):
    out = execute(plan)
    # An out-of-bounds gather queued right after the walk: a device-side
    # assert that the host sees only when it next waits on the stream.
    out[torch.full((1,), 1 << 40, dtype=torch.int64, device=out.device)]
    return out

svc.session.execute = faulting
b = svc.start_pipeline(config=ControllerConfig(max_batch=1),
                       predictive=False)
t = svc.submit("a", 16, retries=1)
try:
    t.result(timeout=60)
except RuntimeError as e:
    err = str(e)
else:
    raise SystemExit("the CUDA error did not reach the ticket")
b.drain(timeout=60)
snap = b.snapshot()
print("ERR", err.splitlines()[0])
print("SNAP", snap["dispatch_errors"], snap["retries"],
      snap["worker_restarts"], snap["completed"], flush=True)
import os
os._exit(0)
"""


@pytest.mark.parametrize("observe", [True, False])
@in_child
def test_cuda_error_at_the_wait_reaches_the_failure_handler(cuda_device,
                                                            observe):
    """A CUDA error raised at a group's wait (a device-side assert queued
    after the walk, in a child process because it poisons the context)
    reaches the broker's dispatch failure handler, for a ticket with one
    retry, and no worker crashes.

    With traces on (``observe=True``, the default) the service waits inside
    ``dispatch_group``, before it fulfills the ticket: the handler spends
    the retry, the retry faults on the poisoned context, and the ticket
    carries the error (2 dispatch errors, 1 retry).  With traces off the
    service fulfills the ticket at the launch and the broker's own wait
    raises, as the reference's ``block_until_ready`` does after its
    fulfillment: ``dispatch_errors`` counts it, the fulfilled ticket is not
    retried, and the error reaches the caller through ``result()``'s own
    wait (1 dispatch error, 0 retries)."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    out = subprocess.run(
        [sys.executable, "-c", CUDA_ERROR_AT_THE_WAIT,
         "observe" if observe else "quiet"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": src}, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("ERR ", "SNAP ")))
    assert "CUDA" in lines["ERR"] or "device-side" in lines["ERR"], lines
    want = ["2", "1", "0", "1"] if observe else ["1", "0", "0", "1"]
    assert lines["SNAP"].split() == want, lines


# ----------------------------------------------------------------------
# The sharded executor on the card: shards of (cuda:0,) * k
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("ways", [16, 32, 64])
@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_sharded_decode_on_the_card(cuda_device, k, ways, layout):
    """A sharded service over ``(cuda:0,) * k`` at 5 and 64 threads (at k =
    4, 5 splits leave the last shard empty) and in a fused group: every
    output equals the plain sharded path on a CPU mesh of k entries, the
    unsharded CUDA service and the symbols; each shard with rows launched
    once, the empty one not at all, and no plain walk ran on the card."""
    import torch
    from repro_torch.kernels.rans_decode.rans_decode import (
        reset_counts, walk_decode_pointer, walk_decode_symbol)
    from repro_torch.launch.mesh import make_decode_mesh
    from repro_torch.runtime.serve import DecodeService
    syms, model, enc, _ = _content(40 + ways, 30_000, ways, 11, 64)

    def service(**kw):
        svc = DecodeService(model, layout=layout, **kw)
        svc.ingest("a", syms, 64)
        return svc
    card = service(impl="sharded",
                   mesh=make_decode_mesh(devices=(cuda_device,) * k))
    assert card.session.device == cuda_device
    assert card.layout_for("a") == layout
    plain = service(impl="sharded",
                    mesh=make_decode_mesh(devices=("cpu",) * k))
    whole = service(device=cuda_device)
    reqs = [("a", 5), ("a", 64), ("a", 16)]
    want = {th: plain.decode("a", th) for _, th in reqs}
    reset_counts()
    walk = walk_decode_symbol if layout == "symbol" else walk_decode_pointer
    shards = {th: len(card.prepare_request("a", th).args) for _, th in reqs}
    if k == 4:
        assert shards[5] == 3
    for _, th in reqs:
        before = walk.launches
        out = card.decode("a", th)
        assert out.device == cuda_device
        assert walk.launches - before == shards[th]
        assert torch.equal(out.cpu(), want[th])
        assert torch.equal(out, whole.decode("a", th))
        assert (out.cpu().numpy() == syms).all()
    tickets = [card.submit(n, th) for n, th in reqs]
    card.flush()
    for t in tickets:
        assert (t.result().cpu().numpy() == syms).all()
    assert card.stats.fused_dispatches == 1
    assert walk_decode_pointer.plain_calls + walk_decode_symbol.plain_calls \
        == 0


@in_child
def test_sharded_session_on_the_card_refuses_another_device(cuda_device):
    """The default mesh covers every visible card; a ``device=`` other than
    the mesh's first device raises, and so does a mesh of mixed device
    types."""
    import torch
    from repro_torch.core.engine import DecoderSession
    from repro_torch.launch.mesh import DecodeMesh, make_decode_mesh
    _, model, _, _ = _content(3, 5_000, 32, 11, 8)
    mesh = make_decode_mesh()
    assert len(mesh.devices) == torch.cuda.device_count()
    with pytest.raises(ValueError, match="one type"):
        DecodeMesh(("cpu", cuda_device), ("shard",), (2,))
    sess = DecoderSession(model, impl="sharded")
    assert sess.impl == "sharded" and sess.device == mesh.devices[0]
    with pytest.raises(ValueError, match="first device"):
        DecoderSession(model, impl="sharded",
                       mesh=make_decode_mesh(devices=(cuda_device,) * 2),
                       device="cpu")


@pytest.mark.parametrize("order", ["every card", "interleaved"])
@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_sharded_decode_across_cards(cuda_device, layout, order):
    """A mesh over distinct cards (every visible card, or two cards
    interleaved as (0, 1, 0, 1)): shards run on their own cards, each
    card's words are re-pinned once and reused warm, the merged output
    lands on the first card and equals the unsharded decode, the symbols
    and a fused group through the broker.  Skips with fewer than 2 cards."""
    import torch
    from repro_torch.kernels.rans_decode.rans_decode import (
        reset_counts, walk_decode_pointer, walk_decode_symbol)
    from repro_torch.launch.mesh import make_decode_mesh
    from repro_torch.runtime.serve import DecodeService
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    mesh = (make_decode_mesh() if order == "every card" else
            make_decode_mesh(devices=[cards[0], cards[1]] * 2))
    syms, model, _, _ = _content(11, 30_000, 32, 11, 64)
    svc = DecodeService(model, impl="sharded", mesh=mesh, layout=layout)
    whole = DecodeService(model, device=cards[0], layout=layout)
    for s in (svc, whole):
        s.ingest("a", syms, 64)
    from repro_torch.core.recoil import build_split_states, combine_plan
    from repro_torch.core.vectorized import WalkBatch
    ex = svc.session.executor
    reset_counts()
    for th in (5, 16, 64):
        plan = svc.prepare_request("a", th)
        assert {sh.device for sh in plan.args} <= set(mesh.devices)
        out = svc.decode("a", th)
        assert out.device == cards[0]
        assert torch.equal(out, whole.decode("a", th))
        assert (out.cpu().numpy() == syms).all()
    pins = {k: v for k, (_, v) in ex._repl_cache.items()}
    assert len(pins) == len(set(mesh.devices))
    c = svc.content("a")
    for th in (5, 16, 64):       # fresh plans reuse every card's copy
        p = combine_plan(c.plan, th)
        batch = WalkBatch.from_splits(build_split_states(p, c.final_states),
                                      p.ways)
        out = svc.session.execute(
            svc.session.prepare(batch, c.stream, p.n_symbols))
        assert torch.equal(out, whole.decode("a", th))
    assert all(ex._repl_cache[k][1] is v for k, v in pins.items())
    assert len(ex._repl_cache) == len(pins)
    with svc.start_pipeline() as broker:
        tickets = [broker.submit("a", th) for th in (5, 16, 64)]
        for t in tickets:
            assert (t.result(timeout=60).cpu().numpy() == syms).all()
    svc.stop_pipeline()
    assert walk_decode_pointer.plain_calls + walk_decode_symbol.plain_calls \
        == 0


# ---------------------------------------------------------------------------
# The LM and its Recoil checkpoint on the card
# ---------------------------------------------------------------------------

def _smoke_lm(arch):
    """A float32 smoke LM with parameters from a seeded CPU generator."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    lm = LM(get_smoke_config(arch), param_dtype=torch.float32)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return lm, lm.init(gen, device="cpu")


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen3_4b", "granite_3_2b", "qwen15_32b",
                                  "h2o_danube3_4b", "chameleon_34b",
                                  "seamless_m4t_medium", "grok1_314b",
                                  "llama4_scout_17b_a16e", "hymba_1_5b",
                                  "mamba2_2_7b"])
@in_child
def test_serve_engine_on_the_card_matches_cpu(cuda_device, arch):
    """Greedy tokens of a smoke config at float32 (TF32 off), every family:
    the card's ``ServeEngine`` gives the CPU path's tokens (the
    encoder-decoder from the same numpy frames)."""
    import torch
    from repro_torch.runtime.serve import ServeEngine
    assert not torch.backends.cuda.matmul.allow_tf32
    lm, params = _smoke_lm(arch)
    card = _on(params, cuda_device)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, lm.cfg.vocab, (2, 40))
    frames = (rng.normal(size=(2, lm.cfg.enc_frames, lm.cfg.d_model))
              .astype(np.float32) if lm.cfg.is_encdec else None)
    want, _ = ServeEngine(lm, params, cache_len=64).generate(
        prompt, 16, frames=frames)
    got, st = ServeEngine(lm, card, cache_len=64).generate(
        prompt, 16, frames=frames)
    np.testing.assert_array_equal(got, want)
    assert st.decode_ms_per_token > 0


@in_child
def test_checkpoint_on_the_card_matches_cpu(cuda_device):
    """A recoil checkpoint saved on the card is the CPU path's, file for
    file; a restore on the card equals one on the CPU at 1, 4 and 64
    threads; the card's ingest and walk kernels served every recoil leaf
    and no plain version did."""
    import json
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.kernels.rans_encode import rans_encode as re_
    lm, params = _smoke_lm("qwen3_4b")
    card = {"params": _on(params, cuda_device)}
    with tempfile.TemporaryDirectory() as d:
        on_card = CheckpointManager(root=os.path.join(d, "card"),
                                    codec="recoil", recoil_splits=64)
        on_cpu = CheckpointManager(root=os.path.join(d, "cpu"),
                                   codec="recoil", recoil_splits=64,
                                   device="cpu")
        rd.reset_counts()
        re_.reset_counts()
        a = on_card.save(1, card)
        assert re_.encode_scan.plain_calls + re_.plan_splits.plain_calls == 0
        b = on_cpu.save(1, {"params": params})
        for f in sorted(os.listdir(a)):
            assert open(os.path.join(a, f), "rb").read() == \
                open(os.path.join(b, f), "rb").read(), f
        manifest = json.load(open(os.path.join(a, "manifest.json")))
        n = sum(e["codec"] == "recoil" for e in manifest["leaves"].values())
        assert re_.encode_scan.launches == re_.plan_splits.launches == n
        for threads in (1, 4, 64):
            rd.reset_counts()
            got, _ = on_card.restore(n_threads=threads)
            assert rd.walk_decode_pointer.launches == n
            assert rd.walk_decode_pointer.plain_calls == 0
            want, _ = on_card.restore(n_threads=threads, device="cpu")
            for k, w in want["params"]["layers"].items():
                g = got["params"]["layers"][k]
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), w), k
            assert torch.equal(got["params"]["embed"].cpu(),
                               want["params"]["embed"])


@pytest.mark.parametrize("arch", ["granite_3_2b", "grok1_314b",
                                  "mamba2_2_7b", "hymba_1_5b",
                                  "seamless_m4t_medium"])
@in_child
def test_train_step_on_the_card_matches_cpu(cuda_device, arch):
    """A train step of a smoke config at float32 (TF32 off), remat "dots",
    2 micro-batches, on the card against the CPU path, held as
    ``chip_smoke.py``'s float32 twin is: the loss within 1e-5 relative,
    each accumulated gradient leaf within 1e-3 of its max |value|, and
    AdamW on the card, given the CPU's gradients, within 1e-6 relative of
    the CPU's update.  (After several steps the two paths part further:
    AdamW's first updates move a weight whose gradient is near zero by up
    to the learning rate whichever way its rounding falls.)"""
    import dataclasses
    import torch
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import (AdamWConfig, apply_adamw,
                                         init_moments, tree_leaves,
                                         tree_map)
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train import (init_state, make_grad_fn,
                                           make_train_step)
    lm, params = _smoke_lm(arch)
    lm = LM(dataclasses.replace(lm.cfg, remat="dots"),
            param_dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, lm.cfg.vocab, (4, 32)).astype(np.int32))}
    if lm.cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            4, lm.cfg.enc_frames, lm.cfg.d_model)).astype(np.float32))
    card_params = _on(params, cuda_device)
    grad_fn = make_grad_fn(lm.loss, 2)
    loss_h, g_h = grad_fn(params, batch)
    loss_c, g_c = grad_fn(card_params, _on(batch, cuda_device))
    assert loss_c.device.type == "cuda"
    assert abs(float(loss_c) - float(loss_h)) <= 1e-5 * abs(float(loss_h))
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_h)):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-3 * float(b.abs().max()))
    lr = torch.tensor(1e-3)
    want_p, want_o, _ = apply_adamw(params, g_h, init_moments(params), lr,
                                    AdamWConfig())
    got_p, got_o, _ = apply_adamw(
        card_params, tree_map(lambda g: g.to(cuda_device), g_h),
        init_moments(card_params), lr.to(cuda_device), AdamWConfig())
    for a, b in zip(tree_leaves(got_p) + tree_leaves(got_o),
                    tree_leaves(want_p) + tree_leaves(want_o)):
        torch.testing.assert_close(a.cpu().float(), b.float(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
    state, m = make_train_step(lm.loss, constant(1e-3), accum_steps=2)(
        init_state(card_params), batch)
    assert float(m["loss"]) == float(loss_c)
    assert all(v.device.type == "cuda" for v in m.values())


@in_child
def test_save_async_snapshots_card_tensors_to_pinned_memory(cuda_device):
    """``save_async`` copies card tensors into pinned host memory before
    its thread starts: writes to the tensors right after it do not reach
    the files, which equal a synchronous save's of the tree as it was (with
    its keys sorted, as the snapshot, like the reference's, sorts them)."""
    import tempfile
    import torch
    from repro_torch.checkpoint import manager as mgr_lib
    lm, params = _smoke_lm("granite_3_2b")
    tree = {"params": _on(params, cuda_device)}
    snap = mgr_lib._snapshot(tree)
    leaves = mgr_lib._flatten(snap)
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in leaves.values())
    torch.cuda.synchronize()
    for name, t in mgr_lib._flatten(tree).items():
        assert torch.equal(leaves[name], t.cpu()), name
    def key_sorted(t):      # the snapshot's leaf order, the reference's
        return {k: key_sorted(t[k]) if isinstance(t[k], dict) else t[k]
                for k in sorted(t)}
    with tempfile.TemporaryDirectory() as d:
        a = mgr_lib.CheckpointManager(root=os.path.join(d, "a"),
                                      codec="recoil", recoil_splits=64)
        b = mgr_lib.CheckpointManager(root=os.path.join(d, "b"),
                                      codec="recoil", recoil_splits=64)
        b.save(1, key_sorted(tree))
        a.save_async(1, tree)
        for t in mgr_lib._flatten(tree).values():
            t.add_(1.0)
        a.wait()
        for f in sorted(os.listdir(b._step_dir(1))):
            assert open(os.path.join(a._step_dir(1), f), "rb").read() == \
                open(os.path.join(b._step_dir(1), f), "rb").read(), f

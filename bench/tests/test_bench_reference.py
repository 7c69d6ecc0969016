"""The plain reference against the program's host encoder and packer: it
reads their containers, decodes every split to the content, and calls any
changed word, state or table wrong."""

import numpy as np
import pytest
import torch

from bench import content, reference

DIST = {"kind": "exponential", "scale": 25.5, "clip": 255}


def _encoded(n, threads, seed=11):
    from repro_torch.core import container, recoil
    from repro_torch.core.rans import RansParams, StaticModel, build_cdf
    from repro_torch.core.vectorized import encode_interleaved_fast
    f = content.quantize(content.pmf(DIST), 11)
    f32 = f.astype(np.uint32)
    model = StaticModel(f=f32, F=build_cdf(f32), params=RansParams(11, ways=32))
    syms = content.draw(DIST, 1, n, seed, "cpu")[0]
    enc = encode_interleaved_fast(syms.numpy().astype(np.int64), model)
    buf = container.pack_recoil(enc, model, recoil.plan_splits(enc, threads))
    return f, syms, enc, buf


def _stream(c, words=None, finals=None):
    return reference.Stream(
        words=torch.as_tensor((c.words if words is None else words)
                              .astype(np.int32)),
        finals=c.finals if finals is None else finals, offsets=c.offsets,
        ks=c.ks, ys=c.ys, n_symbols=c.n_symbols)


@pytest.mark.parametrize("threads", [1, 4, 64])
def test_reads_and_decodes_the_programs_container(threads):
    f, syms, enc, buf = _encoded(30000, threads)
    c = reference.parse_container(buf)
    assert np.array_equal(c.words, enc.stream)
    assert np.array_equal(c.freqs, f) and c.n_threads == min(
        threads, c.n_threads) and len(c.offsets) == c.n_threads - 1
    v = reference.walk([_stream(c), _stream(c)], f, 11, 32, "cpu")
    assert reference.wrong_symbols(v.symbols, torch.cat([syms, syms])) == 0
    assert v.bad_ends == 0


def test_every_changed_word_is_caught():
    """Each word near a split anchor (where a split-parallel walk reads a
    word only in its discarded part) and a sample of the rest."""
    f, syms, enc, buf = _encoded(6000, 8)
    c = reference.parse_container(buf)
    near = {int(q) + d for q in c.offsets for d in range(-40, 41)}
    rng = np.random.default_rng(0)
    sample = set(rng.choice(c.n_words, 60, replace=False).tolist())
    for q in sorted((near | sample) & set(range(c.n_words))):
        w = c.words.copy()
        w[q] ^= 1 << int(rng.integers(16))
        v = reference.walk([_stream(c, words=w)], f, 11, 32, "cpu")
        assert reference.wrong_symbols(v.symbols, syms) or v.bad_ends, q


def test_changed_states_and_tables_are_caught():
    f, syms, enc, buf = _encoded(20000, 16)
    c = reference.parse_container(buf)
    finals = c.finals.copy()
    finals[3] ^= 1 << 20
    v = reference.walk([_stream(c, finals=finals)], f, 11, 32, "cpu")
    assert reference.wrong_symbols(v.symbols, syms) > 0
    ys = c.ys.copy()
    ys[5, 7] ^= 1
    s = _stream(c)
    s.ys = ys
    v = reference.walk([s], f, 11, 32, "cpu")
    assert reference.wrong_symbols(v.symbols, syms) or v.bad_ends
    f10 = content.quantize(content.pmf(DIST), 10)
    v = reference.walk([_stream(c)], f10, 10, 32, "cpu")
    assert reference.wrong_symbols(v.symbols, syms) > 1000


def test_malformed_containers_are_refused():
    _, _, _, buf = _encoded(5000, 4)
    with pytest.raises(ValueError):
        reference.parse_container(buf[:-2])
    with pytest.raises(ValueError):
        reference.parse_container(b"XXXX" + buf[4:])

"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's, on the CPU (``device="cpu"``: the plain torch versions of the
ingest and walk kernels).

Mirrors ``tests/test_data_and_sharding.py``'s data tests and holds more:
``SyntheticCorpus`` batches equal to the reference's; the Recoil shard
store's ``.rcl`` files byte-equal to the reference store's, at n = 14 with
an 8,000-token vocabulary (the store's default) and at n = 16 with a Zipf
sample over granite_3_2b's 49,155-token vocabulary; reads thinned to 1, 4
and 128 threads equal to the tokens; ``ShardedCorpus`` batches equal to the
reference's over the same shard.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import os
import tempfile

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core.rans import RansParams as JRansParams
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import RecoilShardStore as JStore
from repro.data.pipeline import ShardedCorpus as JShardedCorpus
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus

GRANITE_VOCAB = 49_155


def _tokens(kind):
    rng = np.random.default_rng(0)
    if kind == "uniform_8000":
        return rng.integers(0, 8000, size=200_000)
    return np.minimum(rng.zipf(1.3, size=200_000) - 1, GRANITE_VOCAB - 1)


def _stores(root, n_bits):
    from repro_torch.core.rans import RansParams
    from repro_torch.data.pipeline import RecoilShardStore
    if n_bits == 14:     # the stores' default params
        return (JStore(os.path.join(root, "ref")),
                RecoilShardStore(os.path.join(root, "port"), device="cpu"))
    return (JStore(os.path.join(root, "ref"),
                   params=JRansParams(n_bits=n_bits, ways=32)),
            RecoilShardStore(os.path.join(root, "port"),
                             params=RansParams(n_bits=n_bits, ways=32),
                             device="cpu"))


@in_child
def test_synthetic_corpus_equals_reference():
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    for kw in (dict(vocab=1000, seq_len=16, global_batch=8, seed=7),
               dict(vocab=GRANITE_VOCAB, seq_len=64, global_batch=4)):
        for hosts in ((0, 1), (0, 2), (1, 2)):
            a = SyntheticCorpus(DataConfig(**kw), *hosts)
            b = JSyntheticCorpus(JDataConfig(**kw), *hosts)
            for step in (0, 3, 17):
                got, want = a.batch(step)["tokens"], b.batch(step)["tokens"]
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_bits,kind", [(14, "uniform_8000"),
                                         (16, "zipf_granite")])
@in_child
def test_shard_files_equal_reference(n_bits, kind):
    """``write_shard`` at 128 splits: the same info and a byte-equal
    ``.rcl`` file; at n = 16 the tokens pass 2^14 (the n = 14 store
    refuses them, as the reference's does)."""
    toks = _tokens(kind)
    with tempfile.TemporaryDirectory() as d:
        jstore, tstore = _stores(d, n_bits)
        want = jstore.write_shard("s0", toks, max_splits=128)
        got = tstore.write_shard("s0", toks, max_splits=128)
        assert got == want and got["splits"] == 128
        with open(jstore._path("s0"), "rb") as f, \
                open(tstore._path("s0"), "rb") as g:
            assert f.read() == g.read()
        if n_bits == 16:
            assert toks.max() >= 1 << 14
            with pytest.raises(ValueError):
                _stores(d, 14)[1].write_shard("s1", toks)


@pytest.mark.parametrize("n_bits,kind", [(14, "uniform_8000"),
                                         (16, "zipf_granite")])
@in_child
def test_shard_reads_equal_the_tokens(n_bits, kind):
    """Reads thinned to 1, 4 and 128 threads equal the tokens, and each
    store reads the other's file."""
    toks = _tokens(kind)
    with tempfile.TemporaryDirectory() as d:
        jstore, tstore = _stores(d, n_bits)
        tstore.write_shard("s0", toks, max_splits=128)
        jstore.write_shard("s1", toks, max_splits=128)
        for threads in (1, 4, 128):
            back = tstore.read_shard("s0", n_threads=threads)
            assert back.dtype == np.int32
            np.testing.assert_array_equal(back, toks)
        from repro_torch.data.pipeline import RecoilShardStore
        np.testing.assert_array_equal(RecoilShardStore(
            jstore.root, params=tstore.params, device="cpu").read_shard(
                "s1", 4), toks)
        np.testing.assert_array_equal(
            JStore(tstore.root, params=jstore.params).read_shard("s0", 4),
            toks)


@in_child
def test_sharded_corpus_equals_reference():
    from repro_torch.data.pipeline import DataConfig, ShardedCorpus
    toks = _tokens("uniform_8000")
    with tempfile.TemporaryDirectory() as d:
        jstore, tstore = _stores(d, 14)
        jstore.write_shard("s0", toks[:120_000], max_splits=64)
        jstore.write_shard("s1", toks[120_000:], max_splits=64)
        tstore.write_shard("s0", toks[:120_000], max_splits=64)
        tstore.write_shard("s1", toks[120_000:], max_splits=64)
        kw = dict(vocab=8000, seq_len=32, global_batch=4)
        for hosts in (dict(), dict(host_index=1, n_hosts=2)):
            a = ShardedCorpus(tstore, ["s0", "s1"], DataConfig(**kw),
                              n_threads=8, **hosts)
            b = JShardedCorpus(jstore, ["s0", "s1"], JDataConfig(**kw),
                               n_threads=8, **hosts)
            for step in (0, 1, 5000):
                got, want = a.batch(step)["tokens"], b.batch(step)["tokens"]
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)

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
    assert ts.stats.snapshot() == js.stats.snapshot()
    assert (ts.stats.compiles, ts.stats.cache_hits) == (1, 1)
    assert ts.executables == 1


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
    with pytest.raises(ValueError):
        DecoderSession(tm, device="cpu", impl="cuda")
    if torch.cuda.is_available():
        assert DecoderSession(tm).impl == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecoderSession(tm)

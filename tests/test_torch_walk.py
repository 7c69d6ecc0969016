"""The port's plain walks against the JAX package's reference walks.

Same content (made from a seed with numpy, encoded by the reference) goes
through ``repro.kernels.rans_decode.ref.walk_reference`` /
``repro.core.vectorized._walk_batch_symbol_jit`` and through the port's
plain torch walks on the CPU.  The codec is integer-exact, so every
comparison is equality: tiles, final pointers ``qf`` and flat outputs.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and torch and the port are imported inside the tests, so the test worker
itself never loads torch beside jaxlib.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import conventional as j_conventional
from repro.core import recoil as j_recoil
from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.core.vectorized import (WalkBatch as JBatch,
                                   _walk_batch_symbol_jit,
                                   decode_conventional_fast as j_conv_fast,
                                   decode_recoil_fast as j_recoil_fast,
                                   encode_interleaved_fast as j_encode,
                                   words_by_symbol_host as j_wbs)
from repro.kernels.rans_decode.ops import _luts as j_luts
from repro.kernels.rans_decode.ref import (decode_reference as j_decode_ref,
                                           walk_reference as j_walk_ref)


def _make(seed=0, n=12_000, ways=32, n_bits=11, alphabet=256, lam=40.0):
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.exponential(lam, size=n).astype(np.int64),
                      alphabet - 1)
    model = JModel.from_symbols(syms, alphabet, JParams(n_bits=n_bits,
                                                        ways=ways))
    return syms, model, j_encode(syms, model)


def _port_model(jm):
    from repro_torch.core import convert
    return convert.model_from_arrays(jm.f, jm.F, jm.params.n_bits,
                                     jm.params.ways)


def _batches(enc, n_splits):
    from repro_torch.core import convert
    plan = j_recoil.plan_splits(enc, n_splits)
    jb = JBatch.from_splits(
        j_recoil.build_split_states(plan, enc.final_states), plan.ways)
    tb = convert.batch_from_arrays(convert.batch_arrays(jb), jb.n_steps,
                                   jb.ways)
    return plan, jb, tb


def _check_pointer(syms, jm, enc, n_splits):
    """Tiles + qf against walk_reference, and the flat decode under every
    slot-table layout the model allows against decode_reference."""
    import torch
    from repro_torch.core import convert
    from repro_torch.core.vectorized import decode_recoil_fast
    from repro_torch.kernels.rans_decode import (decode, decode_recoil_kernel,
                                                 walk_reference)
    from repro_torch.kernels.rans_decode.ops import (packed_lut_ok,
                                                     scatter_outputs)
    plan, jb, tb = _batches(enc, n_splits)
    tm = _port_model(jm)
    j_tiles, j_qf = j_walk_ref(jb, enc.stream, jm)
    t_tiles, t_qf = walk_reference(tb, enc.stream, tm)
    np.testing.assert_array_equal(t_tiles, np.asarray(j_tiles))
    np.testing.assert_array_equal(t_qf, np.asarray(j_qf))
    ref = j_decode_ref(jb, enc.stream, jm, plan.n_symbols)
    np.testing.assert_array_equal(ref, syms)
    flat = scatter_outputs(torch.from_numpy(t_tiles),
                           torch.from_numpy(tb.g_hi),
                           torch.from_numpy(tb.out_base),
                           n_symbols=plan.n_symbols)
    np.testing.assert_array_equal(flat.numpy(), ref)
    for packed in sorted({False, packed_lut_ok(tm)}):
        out = decode(tb, enc.stream, tm, plan.n_symbols, device="cpu",
                     packed_lut=packed)
        np.testing.assert_array_equal(out.numpy(), ref)
    t_plan = convert.plan_from_arrays(**convert.plan_arrays(plan))
    out = decode_recoil_kernel(t_plan, enc.stream, enc.final_states, tm,
                               device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        decode_recoil_fast(t_plan, enc.stream, enc.final_states, tm),
        j_recoil_fast(plan, enc.stream, enc.final_states, jm))


@pytest.mark.parametrize("ways", [8, 16, 32, 64, 128])
@in_child
def test_walk_way_sweep(ways):
    syms, jm, enc = _make(ways=ways, n=12_000)
    _check_pointer(syms, jm, enc, 16)


@pytest.mark.parametrize("n_bits", [8, 11, 14, 16])
@in_child
def test_walk_quantization_sweep(n_bits):
    syms, jm, enc = _make(n_bits=n_bits, n=10_000)
    _check_pointer(syms, jm, enc, 12)


@in_child
def test_walk_4096_symbol_alphabet():
    """16-bit symbols (paper Table 3 sizeof(s) = 16) at n = 14: the
    three-table layout only."""
    rng = np.random.default_rng(5)
    syms = rng.integers(0, 4096, size=8_000)
    jm = JModel.from_symbols(syms, 4096, JParams(n_bits=14, ways=32))
    _check_pointer(syms, jm, j_encode(syms, jm), 12)


@pytest.mark.parametrize("n", [999, 4096, 17_331])
@pytest.mark.parametrize("splits", [3, 17])
@in_child
def test_walk_shape_sweep(n, splits):
    syms, jm, enc = _make(n=n, seed=n)
    _check_pointer(syms, jm, enc, splits)


@pytest.mark.parametrize("perm", ["u16", "u32"])
@pytest.mark.parametrize("packed", [False, True])
@in_child
def test_symbol_walk_matches_reference(perm, packed):
    """The plain symbol walk against ``_walk_batch_symbol_jit`` on the same
    permutation, u16 or u32, under both slot-table layouts."""
    import torch
    from repro_torch.core.vectorized import (_walk_batch_symbol_impl,
                                             walk_decode_batch_symbol)
    from repro_torch.kernels.rans_decode.ops import _luts
    syms, jm, enc = _make(n=9_000, seed=3)
    plan, jb, tb = _batches(enc, 10)
    n = plan.n_symbols
    W = jb.ways
    bucket = -(-n // 1024) * 1024
    wbs = np.zeros(bucket, np.uint32)
    wbs[:n] = j_wbs(enc.stream, enc.k_of_word, n)
    wbs = wbs.astype(np.uint16 if perm == "u16" else np.uint32)
    tm = _port_model(jm)
    t_luts = _luts(tm, packed, "cpu")
    j_out = _walk_batch_symbol_jit(
        jnp.asarray(wbs), *j_luts(jm, packed),
        jnp.asarray(jb.k), jnp.asarray(jb.y), jnp.asarray(jb.x0),
        jnp.asarray(jb.sym_bases()), jnp.asarray(jb.g_hi),
        jnp.asarray(jb.start), jnp.asarray(jb.stop), jnp.asarray(jb.keep_lo),
        jnp.asarray(jb.keep_hi), jnp.asarray(jb.out_base),
        n_bits=jm.params.n_bits, ways=W, n_steps=jb.n_steps, n_symbols=n)
    view = np.int16 if perm == "u16" else np.int32

    def t(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a.astype(np.int32))

    t_out = _walk_batch_symbol_impl(
        torch.from_numpy(wbs.view(view)), *t_luts, t(tb.k), t(tb.y),
        t(tb.x0), t(tb.sym_bases()), t(tb.g_hi), t(tb.start), t(tb.stop),
        t(tb.keep_lo), t(tb.keep_hi), t(tb.out_base),
        n_bits=jm.params.n_bits, ways=W, n_steps=tb.n_steps, n_symbols=n)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_out.numpy(), syms)
    np.testing.assert_array_equal(
        walk_decode_batch_symbol(tb, wbs, tm, n, packed_lut=packed), syms)


@in_child
def test_conventional_adapter_matches_reference():
    from repro_torch.core import conventional as t_conventional
    from repro_torch.core.vectorized import WalkBatch, decode_conventional_fast
    from repro_torch.kernels.rans_decode import decode
    syms, jm, enc = _make(n=15_000)
    j_conv = j_conventional.encode_conventional(syms, jm, 9)
    t_conv = t_conventional.encode_conventional(syms, _port_model(jm), 9)
    j_out = j_conv_fast(j_conv, jm)
    t_out = decode_conventional_fast(t_conv, _port_model(jm))
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out, syms)
    states, words, out_bases = t_conventional.to_split_states(t_conv)
    batch = WalkBatch.from_splits(states, 32, out_bases)
    out = decode(batch, words, _port_model(jm), t_conv.n_symbols,
                 device="cpu")
    np.testing.assert_array_equal(out.numpy(), syms)


@in_child
def test_wrappers_take_the_plain_walk_only_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain walks and count them as
    plain calls, never as kernel launches."""
    from repro_torch.kernels.rans_decode import decode
    from repro_torch.kernels.rans_decode.rans_decode import (
        reset_counts, walk_decode_pointer, walk_decode_symbol)
    syms, jm, enc = _make(n=3_000, seed=11)
    plan, _, tb = _batches(enc, 4)
    reset_counts()
    decode(tb, enc.stream, _port_model(jm), plan.n_symbols, device="cpu")
    assert walk_decode_pointer.plain_calls == 1
    assert walk_decode_pointer.launches == 0
    assert walk_decode_symbol.launches == 0
    reset_counts()

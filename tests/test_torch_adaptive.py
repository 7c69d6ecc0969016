"""The port's adaptive walk twin against the JAX package's.

``tests/test_conformance.py::test_conformance_adaptive``'s cases (seeds 7
and 8): a 4-context model, its host encoder (``encode_adaptive_fast``), the
python oracle (``walk_decode_split_adaptive``) and both plain walks with
``ctx_model=`` must equal the symbols -- and the port's encoder, pointer
walk and symbol walk must equal the reference's jnp encoder and walks,
integer for integer.  The adaptive walks run on host tensors only: neither
walk kernel takes a context map.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and torch and the port are imported inside the tests.
"""

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import recoil as j_recoil
from repro.core.adaptive import ContextModel as JContextModel
from repro.core.rans import RansParams as JParams
from repro.core.recoil import build_split_states as j_build
from repro.core.vectorized import WalkBatch as JBatch
from repro.core.vectorized import decode_recoil_fast as j_decode_fast
from repro.core.vectorized import encode_adaptive_fast as j_encode
from repro.core.vectorized import walk_decode_batch as j_walk
from repro.core.vectorized import walk_decode_batch_symbol as j_walk_symbol
from repro.core.vectorized import words_by_symbol_host as j_wbs

CASES = [(7, 4_000, 12), (8, 2_321, 5)]


def _case(seed, n):
    rng = np.random.default_rng(seed)
    ctx = (np.arange(n) // 512 % 4).astype(np.int64)
    syms = np.clip(rng.normal(128, 5 + 20 * ctx, size=n), 0,
                   255).astype(np.int64)
    return ctx, syms


@pytest.mark.parametrize("seed,n,n_splits", CASES)
@in_child
def test_conformance_adaptive(seed, n, n_splits):
    from repro_torch.core import recoil
    from repro_torch.core.adaptive import (ContextModel,
                                           walk_decode_split_adaptive)
    from repro_torch.core.rans import RansParams
    from repro_torch.core.recoil import build_split_states
    from repro_torch.core.vectorized import (WalkBatch, encode_adaptive_fast,
                                             walk_decode_batch,
                                             walk_decode_batch_symbol,
                                             words_by_symbol_host)
    ctx, syms = _case(seed, n)
    cm = ContextModel.from_scale_table(
        [8.0, 20.0, 40.0, 80.0], ctx, 256, RansParams(n_bits=11, ways=32))
    enc = encode_adaptive_fast(syms, cm)
    plan = recoil.plan_splits(enc, n_splits)

    oracle = np.full(n, -1, np.int64)
    for split in build_split_states(plan, enc.final_states):
        walk_decode_split_adaptive(split, enc.stream, cm, oracle)
    assert (oracle == syms).all()

    batch = WalkBatch.from_splits(
        build_split_states(plan, enc.final_states), plan.ways)
    wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
    ptr = walk_decode_batch(batch, enc.stream, None, n, ctx_model=cm)
    sym = walk_decode_batch_symbol(batch, wbs, None, n, ctx_model=cm)
    assert (ptr == oracle).all(), "adaptive pointer walk != oracle"
    assert (sym == oracle).all(), "adaptive symbol walk != oracle"

    # The same content through the reference: equal encodings, plans and
    # walks, integer for integer.
    jcm = JContextModel.from_scale_table(
        [8.0, 20.0, 40.0, 80.0], ctx, 256, JParams(n_bits=11, ways=32))
    np.testing.assert_array_equal(cm.f, jcm.f)
    jenc = j_encode(syms, jcm)
    for field in ("stream", "final_states", "k_of_word", "y_of_word"):
        np.testing.assert_array_equal(getattr(enc, field),
                                      getattr(jenc, field))
        assert getattr(enc, field).dtype == getattr(jenc, field).dtype
    jplan = j_recoil.plan_splits(jenc, n_splits)
    jbatch = JBatch.from_splits(j_build(jplan, jenc.final_states), jplan.ways)
    np.testing.assert_array_equal(
        ptr, j_walk(jbatch, jenc.stream, None, n, ctx_model=jcm))
    np.testing.assert_array_equal(
        sym, j_walk_symbol(jbatch, j_wbs(jenc.stream, jenc.k_of_word, n),
                           None, n, ctx_model=jcm))


@pytest.mark.parametrize("seed,n,n_splits", CASES)
@in_child
def test_decode_recoil_fast_adaptive_equals_reference(seed, n, n_splits):
    from repro_torch.core import recoil
    from repro_torch.core.adaptive import ContextModel
    from repro_torch.core.rans import RansParams
    from repro_torch.core.vectorized import (decode_recoil_fast,
                                             encode_adaptive_fast)
    ctx, syms = _case(seed, n)
    cm = ContextModel.from_scale_table(
        [8.0, 20.0, 40.0, 80.0], ctx, 256, RansParams(n_bits=11, ways=32))
    jcm = JContextModel.from_scale_table(
        [8.0, 20.0, 40.0, 80.0], ctx, 256, JParams(n_bits=11, ways=32))
    enc, jenc = encode_adaptive_fast(syms, cm), j_encode(syms, jcm)
    plan, jplan = recoil.plan_splits(enc, n_splits), \
        j_recoil.plan_splits(jenc, n_splits)
    out = decode_recoil_fast(plan, enc.stream, enc.final_states, None,
                             ctx_model=cm)
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(
        out, j_decode_fast(jplan, jenc.stream, jenc.final_states, None,
                           ctx_model=jcm))


@in_child
def test_adaptive_walk_tiles_equal_reference_with_inert_rows():
    """The plain walks' context branch on padded split rows (inert rows
    with ``start = -1``), against the reference's jnp walks on the same
    padded arrays: outputs and final stream pointers."""
    import torch
    from repro.core.engine.plan import pad_split_arrays as j_pad
    from repro.core.vectorized import (_walk_batch_jit,
                                       _walk_batch_symbol_jit)
    from repro_torch.core import convert
    from repro_torch.core.engine.plan import pad_split_arrays
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl)
    ctx, syms = _case(9, 3_000)
    jcm = JContextModel.from_scale_table(
        [8.0, 20.0, 40.0, 80.0], ctx, 256, JParams(n_bits=11, ways=32))
    jenc = j_encode(syms, jcm)
    jplan = j_recoil.plan_splits(jenc, 9)
    jb = JBatch.from_splits(j_build(jplan, jenc.final_states), jplan.ways)
    tb = convert.batch_from_arrays(convert.batch_arrays(jb), jb.n_steps,
                                   jb.ways)
    S = jb.k.shape[0]
    slots = jcm.slot_luts()
    slot_f = np.take_along_axis(jcm.f.astype(np.int32), slots, axis=1)
    slot_F = np.take_along_axis(jcm.F[:, :-1].astype(np.int32), slots,
                                axis=1)
    luts = (slots.astype(np.int32), slot_f, slot_F)
    c = jcm.ctx.astype(np.int32)
    st = dict(n_bits=11, ways=32, n_steps=jb.n_steps, n_symbols=len(syms))
    jarrs = j_pad(jb, S + 3)
    tarrs = pad_split_arrays(tb, S + 3, "cpu")
    t_luts = tuple(torch.from_numpy(a) for a in luts)
    words = jenc.stream.astype(np.uint32)
    ptr_fields = ("k", "y", "x0", "q0", "g_hi", "start", "stop", "keep_lo",
                  "keep_hi", "out_base")
    j_out, j_qf = _walk_batch_jit(words, *luts,
                                  *(jarrs[f] for f in ptr_fields), **st,
                                  ctx_of_index=c)
    t_out, t_qf = _walk_batch_impl(
        torch.from_numpy(words.astype(np.int32)), *t_luts,
        *(tarrs[f] for f in ptr_fields), **st,
        ctx_of_index=torch.from_numpy(c))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_qf.numpy(), np.asarray(j_qf))
    np.testing.assert_array_equal(t_out.numpy(), syms)
    wbs = j_wbs(jenc.stream, jenc.k_of_word, len(syms))
    wbs = np.concatenate([wbs, np.zeros((-len(wbs)) % 32, np.uint32)])
    sym_fields = ("k", "y", "x0", "sym_base", "g_hi", "start", "stop",
                  "keep_lo", "keep_hi", "out_base")
    j_sym = _walk_batch_symbol_jit(wbs, *luts,
                                   *(jarrs[f] for f in sym_fields), **st,
                                   ctx_of_index=c)
    t_sym = _walk_batch_symbol_impl(
        torch.from_numpy(wbs.astype(np.int32)), *t_luts,
        *(tarrs[f] for f in sym_fields), **st,
        ctx_of_index=torch.from_numpy(c))
    np.testing.assert_array_equal(t_sym.numpy(), np.asarray(j_sym))
    np.testing.assert_array_equal(t_sym.numpy(), syms)

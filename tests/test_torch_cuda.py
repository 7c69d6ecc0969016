"""The Hopper walk kernels against their plain torch versions, on the card.

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
    words = torch.as_tensor(enc.stream.astype(np.int32), device=dev)
    wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
    wbs = np.concatenate([wbs, np.zeros((-n) % ways, np.uint32)])
    for packed in sorted({False, packed_lut_ok(model)}):
        luts = _luts(model, packed, dev)
        ptr_args = (words, *luts, *(arrs[f] for f in SPLIT_FIELDS))
        out, qf = walk_decode_pointer(*ptr_args, **statics)
        ref_out, ref_qf = _walk_batch_impl(*ptr_args, **statics)
        torch.cuda.synchronize()
        assert torch.equal(out, ref_out) and torch.equal(qf, ref_qf)
        assert (out.cpu().numpy() == syms).all()
        for perm in (np.uint16, np.uint32):
            view = np.int16 if perm == np.uint16 else np.int32
            by = torch.as_tensor(wbs.astype(perm).view(view), device=dev)
            sym_args = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
            out = walk_decode_symbol(*sym_args, **statics)
            ref = _walk_batch_symbol_impl(*sym_args, **statics)
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
    words = torch.as_tensor(enc.stream.astype(np.int32), device=cuda_device)
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


@in_child
def test_service_decodes_through_the_kernels(cuda_device):
    """Both layouts through DecodeService on the card: outputs equal the
    input symbols and only kernel launches served them."""
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

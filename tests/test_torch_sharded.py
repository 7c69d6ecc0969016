"""The port's sharded decode (``parallel/decode_shard.py``,
``launch/mesh.py``) against the JAX package's, on the CPU.

The twins of ``tests/test_sharded_decode.py``'s three cases (even and
ragged split counts, slab thinning with an ingested stream, the smoke mesh
under microbatching) run the port on a CPU mesh of 4 entries (``("cpu",)
* 4``) and the reference's sharded executor over 4 forced host devices.
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set before
jax initialises, and the suite's workers must see one device, so the
reference side runs in a subprocess of its own (the ``_run`` pattern of
``tests/test_sharded_decode.py``) and hands its arrays back through an
``.npz`` in a temporary directory.  Each case holds the port to it: the
output equals the reference's, the port's unsharded session's and the
symbols; each shard's slab equals the reference's slab row for that shard
(u16 against u32 values); the rebased ``q0`` / ``sym_base`` equal the
reference's rows; and the key's split, steps, slab and output buckets
equal the reference's.  Those cases are marked ``slow``, as the
reference's are.

The sharded stress of ``tests/test_pipeline.py`` runs on a sharded
service (its outcome depends on thread timing, so there is nothing to
compare field by field; the reference's own test runs its side).  Cases of
the port alone: the row -> shard assignment and the per-shard windows
against the reference's formula for S in 1..300 and 1 to 4 shards, an
8-chunk stream on a sharded service in both layouts, and the mesh's and
session's refusals.  Each test runs in a child pytest process
(``test_torch_isolation.in_child``); torch and the port are imported inside
the tests.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core.engine.plan import LEGACY_POLICY as J_LEGACY
from repro.parallel.decode_shard import ShardedExecutor as JSharded

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU4 = ("cpu",) * 4

# What the reference's side does before each case: 4 forced host devices,
# and ``dump``, which records a plan's slabs, its rebased q0 or sym_base
# (argument 7 of the walk) and its key's buckets under a name.
_PRELUDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
OUT = {}

def dump(name, dplan, out=None):
    OUT[name + "/slabs"] = np.asarray(dplan.args[0])
    OUT[name + "/base"] = np.asarray(dplan.args[7])
    k = dplan.key
    OUT[name + "/buckets"] = np.asarray([k[8], k[9], k[10], k[-1]])
    if out is not None:
        OUT[name + "/out"] = np.asarray(out)
"""


def _reference(tmp_path, body: str) -> dict:
    """Run ``body`` on the reference in a subprocess with 4 forced host
    devices; returns the arrays it put in ``OUT``."""
    path = os.path.join(str(tmp_path), "reference.npz")
    code = (textwrap.dedent(_PRELUDE) + textwrap.dedent(body)
            + f"\nnp.savez({path!r}, **OUT)\nprint('OK')\n")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, (out.stderr[-3000:], out.stdout[-500:])
    assert "OK" in out.stdout
    with np.load(path) as f:
        return dict(f)


def _mesh(n=4):
    from repro_torch.launch.mesh import make_decode_mesh
    return make_decode_mesh(devices=("cpu",) * n)


def _exp_symbols(seed, n):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)


def _batch(plan, final_states):
    from repro_torch.core.recoil import build_split_states
    from repro_torch.core.vectorized import WalkBatch
    return WalkBatch.from_splits(build_split_states(plan, final_states),
                                 plan.ways)


def _hold_plan(dplan, ref: dict, name: str) -> None:
    """The port's sharded plan against the reference's ``dump``: every
    launched shard's slab and rebased base rows, and the key's buckets;
    shards of padding alone launch nothing."""
    slabs, base = ref[name + "/slabs"], ref[name + "/base"]
    key = dplan.key
    assert [key[8], key[9], key[10], key[-2]] == \
        ref[name + "/buckets"].tolist()
    rows_per = key[8] // len(slabs)
    shards = [sh.shard for sh in dplan.args]
    assert shards == sorted(set(shards))
    for sh in dplan.args:
        a, b = sh.rows
        assert a == sh.shard * rows_per and b > a
        slab = sh.args[0].numpy().view(np.uint16)
        np.testing.assert_array_equal(slab, slabs[sh.shard])
        np.testing.assert_array_equal(sh.args[7].numpy(), base[a:b])
    n_rows = dplan.args[-1].rows[1] if dplan.args else 0
    assert all(sh.shard * rows_per < n_rows for sh in dplan.args)
    assert len(dplan.args) == -(-n_rows // rows_per)


# ----------------------------------------------------------------------
# Twins of tests/test_sharded_decode.py
# ----------------------------------------------------------------------

@pytest.mark.slow
@in_child
def test_sharded_bit_exact_even_and_ragged(tmp_path):
    """15 and 17 splits over 4 shards (16 and 18 rows with the sentinel:
    even and ragged): the output equals the reference sharded executor's,
    the unsharded session's and the symbols, slabs and buckets equal the
    reference's, and a repeat in the same bucket resolves no launcher."""
    import torch
    from repro_torch.core import recoil
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import encode_interleaved_fast
    ref = _reference(tmp_path, """
        from repro.core import recoil
        from repro.core.engine import DecoderSession
        from repro.core.rans import RansParams, StaticModel
        from repro.core.recoil import build_split_states
        from repro.core.vectorized import WalkBatch, encode_interleaved_fast
        rng = np.random.default_rng(0)
        syms = np.minimum(rng.exponential(40.0, size=40_000)
                          .astype(np.int64), 255)
        model = StaticModel.from_symbols(syms, 256,
                                         RansParams(n_bits=11, ways=32))
        enc = encode_interleaved_fast(syms, model)
        sess = DecoderSession(model, impl="sharded")
        assert sess.executor.n_shards == 4
        for n in (15, 17):
            plan = recoil.plan_splits(enc, n)
            batch = WalkBatch.from_splits(
                build_split_states(plan, enc.final_states), plan.ways)
            dplan = sess.prepare(batch, enc.stream, plan.n_symbols)
            dump(f"s{n}", dplan, sess.execute(dplan))
    """)
    syms = _exp_symbols(0, 40_000)
    model = StaticModel.from_symbols(syms, 256,
                                     RansParams(n_bits=11, ways=32))
    enc = encode_interleaved_fast(syms, model)
    plain = DecoderSession(model, device="cpu")
    sess = DecoderSession(model, impl="sharded", mesh=_mesh())
    assert (sess.impl, sess.device, sess.executor.n_shards) == \
        ("sharded", torch.device("cpu"), 4)
    for n in (15, 17):
        plan = recoil.plan_splits(enc, n)
        dplan = sess.prepare(_batch(plan, enc.final_states), enc.stream,
                             plan.n_symbols)
        _hold_plan(dplan, ref, f"s{n}")
        out = sess.execute(dplan)
        np.testing.assert_array_equal(out.numpy(), ref[f"s{n}/out"])
        assert torch.equal(out, plain.decode(plan, enc.stream,
                                             enc.final_states))
        np.testing.assert_array_equal(out.numpy(), syms)
    before = sess.stats.compiles
    plan = recoil.plan_splits(enc, 15)
    sess.decode(plan, enc.stream, enc.final_states)
    assert sess.stats.compiles == before, sess.stats.snapshot()
    assert sess.stats.cache_hits >= 1


@pytest.mark.slow
@in_child
def test_sharded_slab_thinning(tmp_path):
    """Each shard reads only its splits' window: 4 slab rows of at most
    half the stream's bucket, equal to the reference's row for row, with
    the rebased q0; and a stream ingested on the device (``host=None``, the
    symbol layout) through the same executor, held the same way; both
    equal the unsharded session's decode."""
    import torch
    from repro_torch.core import recoil
    from repro_torch.core.encode import EncoderSession
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import encode_interleaved_fast
    ref = _reference(tmp_path, """
        from repro.core import recoil
        from repro.core.encode import EncoderSession
        from repro.core.engine import DecoderSession
        from repro.core.rans import RansParams, StaticModel
        from repro.core.recoil import build_split_states
        from repro.core.vectorized import WalkBatch, encode_interleaved_fast
        rng = np.random.default_rng(2)
        syms = np.minimum(rng.exponential(40.0, size=200_000)
                          .astype(np.int64), 255)
        model = StaticModel.from_symbols(syms, 256,
                                         RansParams(n_bits=11, ways=32))
        enc = encode_interleaved_fast(syms, model)
        sess = DecoderSession(model, impl="sharded")
        ds = sess.upload_stream(enc.stream)
        plan = recoil.plan_splits(enc, 64)
        batch = WalkBatch.from_splits(
            build_split_states(plan, enc.final_states), plan.ways)
        dplan = sess.prepare(batch, ds, plan.n_symbols)
        dump("wire", dplan, sess.execute(dplan))
        res = EncoderSession(model).ingest(syms, 64)
        assert res.stream.host is None
        batch = WalkBatch.from_splits(
            build_split_states(res.plan, res.final_states), res.plan.ways)
        dplan = sess.prepare(batch, res.stream, res.plan.n_symbols)
        OUT["ingest/layout"] = np.asarray(dplan.layout)
        dump("ingest", dplan, sess.execute(dplan))
    """)
    syms = _exp_symbols(2, 200_000)
    model = StaticModel.from_symbols(syms, 256,
                                     RansParams(n_bits=11, ways=32))
    enc = encode_interleaved_fast(syms, model)
    sess = DecoderSession(model, impl="sharded", mesh=_mesh())
    ds = sess.upload_stream(enc.stream)
    plan = recoil.plan_splits(enc, 64)
    dplan = sess.prepare(_batch(plan, enc.final_states), ds, plan.n_symbols)
    assert dplan.layout == "pointer" and len(dplan.args) == 4
    assert dplan.args[0].args[0].shape[0] <= ds.bucket // 2
    _hold_plan(dplan, ref, "wire")
    plain = DecoderSession(model, device="cpu")
    out = sess.execute(dplan)
    np.testing.assert_array_equal(out.numpy(), syms)
    np.testing.assert_array_equal(out.numpy(), ref["wire/out"])
    assert torch.equal(out, plain.decode(plan, enc.stream, enc.final_states))

    res = EncoderSession(model, device="cpu").ingest(syms, 64)
    assert res.stream.host is None
    dplan = sess.prepare(_batch(res.plan, res.final_states), res.stream,
                         res.plan.n_symbols)
    assert dplan.layout == str(ref["ingest/layout"])
    _hold_plan(dplan, ref, "ingest")
    out2 = sess.execute(dplan)
    np.testing.assert_array_equal(out2.numpy(), syms)
    np.testing.assert_array_equal(out2.numpy(), ref["ingest/out"])
    assert torch.equal(out2, plain.decode(res.plan, res.stream,
                                          res.final_states))
    # A shard on the session's device gathers from the resident handle
    # itself, and warm traffic re-pins nothing.
    ex = sess.executor
    assert ex._replicated(ds, "words", sess.device) is ds.words
    n_pins = len(ex._repl_cache)
    sess.decode(plan, ds, enc.final_states)
    assert len(ex._repl_cache) == n_pins


@pytest.mark.slow
@in_child
def test_sharded_smoke_mesh_and_microbatch(tmp_path):
    """A 2-axis smoke mesh (rows shard over the axis product) under the
    service's microbatching: fused rounds bit-exact, the fused plan's slabs
    and buckets equal the reference's, and the counters the reference
    asserts (2 fused dispatches, 1 launcher resolved, 1 cache hit)."""
    from repro_torch.core import recoil
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import encode_interleaved_fast
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime.serve import DecodeService
    ref = _reference(tmp_path, """
        from repro.core import recoil
        from repro.core.rans import RansParams, StaticModel
        from repro.core.vectorized import encode_interleaved_fast
        from repro.launch.mesh import make_smoke_mesh
        from repro.runtime.serve import DecodeService
        rng = np.random.default_rng(1)
        params = RansParams(n_bits=11, ways=32)
        payloads = {f"c{i}": np.minimum(
            rng.exponential(40.0, size=10_000 + 700 * i).astype(np.int64),
            255) for i in range(3)}
        model = StaticModel.from_symbols(
            np.concatenate(list(payloads.values())), 256, params)
        svc = DecodeService(model, impl="sharded", mesh=make_smoke_mesh(),
                            microbatch=8)
        for name, syms in payloads.items():
            enc = encode_interleaved_fast(syms, model)
            svc.register(name, recoil.plan_splits(enc, 12), enc.stream,
                         enc.final_states)
        for _round in range(2):
            tickets = [svc.submit(n, t)
                       for n, t in [("c0", 4), ("c1", 8), ("c2", 12)]]
            svc.flush()
            for i, tk in enumerate(tickets):
                OUT[f"r{_round}/{i}"] = np.asarray(tk.result())
        [(fused, _, _)] = svc._fused_plans.values()
        dump("fused", fused)
        s = svc.stats
        OUT["stats"] = np.asarray([s.fused_dispatches, s.compiles,
                                   s.cache_hits])
    """)
    rng = np.random.default_rng(1)
    params = RansParams(n_bits=11, ways=32)
    payloads = {f"c{i}": np.minimum(
        rng.exponential(40.0, size=10_000 + 700 * i).astype(np.int64), 255)
        for i in range(3)}
    model = StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256, params)
    mesh = make_smoke_mesh(devices=CPU4)
    assert (mesh.axis_names, mesh.shape) == (("data", "model"),
                                             {"data": 2, "model": 2})
    svc = DecodeService(model, impl="sharded", mesh=mesh, microbatch=8)
    plain = DecodeService(model, device="cpu", microbatch=8)
    for name, syms in payloads.items():
        enc = encode_interleaved_fast(syms, model)
        for s in (svc, plain):
            s.register(name, recoil.plan_splits(enc, 12), enc.stream,
                       enc.final_states)
    reqs = [("c0", 4), ("c1", 8), ("c2", 12)]
    for _round in range(2):
        tickets = [svc.submit(n, t) for n, t in reqs]
        svc.flush()
        for i, ((name, th), tk) in enumerate(zip(reqs, tickets)):
            out = tk.result().numpy()
            np.testing.assert_array_equal(out, payloads[name])
            np.testing.assert_array_equal(out, ref[f"r{_round}/{i}"])
            np.testing.assert_array_equal(
                out, plain.decode(name, th).numpy())
    [(fused, _, _)] = svc._fused_plans.values()
    _hold_plan(fused, ref, "fused")
    assert fused.key[3:5] == (4, ("data", "model"))
    s = svc.stats
    assert s.fused_dispatches == 2, s.snapshot()
    assert s.compiles == 1 and s.cache_hits == 1, s.snapshot()
    assert [s.fused_dispatches, s.compiles, s.cache_hits] == \
        ref["stats"].tolist()


# ----------------------------------------------------------------------
# Twin of tests/test_pipeline.py's sharded stress
# ----------------------------------------------------------------------

@pytest.mark.slow
@in_child
def test_threaded_stress_sharded():
    """Concurrent submit during re-ingest across 3 contents on a sharded
    service over a CPU mesh of 4 entries: the stress contract of
    ``tests/test_torch_pipeline.py::test_threaded_stress``."""
    from torch_checks import stress_payloads, threaded_stress
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.runtime.serve import DecodeService
    payloads = stress_payloads()
    model = StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256,
        RansParams(n_bits=11, ways=32))
    svc = DecodeService(model, impl="sharded", mesh=_mesh())
    svc.ingest_batch(payloads, 16)
    threaded_stress(svc, payloads, 30.0)
    assert svc.session.executor.n_shards == 4
    assert svc.session.impl == "sharded"


# ----------------------------------------------------------------------
# The port alone
# ----------------------------------------------------------------------

def _reference_windows(start, stop, lo_of_row, hi_of_row, S, n_shards):
    """The reference's formula (``decode_shard.py`` plan): rows padded to
    the split bucket with ``start = -1``, reshaped (shard, row)."""
    s_b = JSharded._split_bucket(
        types.SimpleNamespace(n_shards=n_shards, policy=J_LEGACY), S)
    rows_per = s_b // n_shards

    def pad(a, fill):
        out = np.full(s_b, fill, np.int64)
        out[:S] = a
        return out
    act = (pad(start, -1) >= 0).reshape(n_shards, rows_per)
    row_lo = pad(lo_of_row, 0).reshape(n_shards, rows_per)
    row_hi = pad(hi_of_row, 0).reshape(n_shards, rows_per)
    lo_s = np.where(act, row_lo, np.int64(1) << 60).min(axis=1)
    hi_s = np.where(act, row_hi, np.int64(-1)).max(axis=1)
    lo_s = np.clip(np.minimum(lo_s, hi_s + 1), 0, None)
    owner = np.repeat(np.arange(n_shards), rows_per)[:S]
    return s_b, owner, lo_s, hi_s


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@in_child
def test_partition_and_windows_equal_the_reference_formula(n_shards):
    """Host-only: for every S in 1..300, the split bucket equals the
    reference's ``_split_bucket``, each row's shard is the reference's, and
    each shard's window is the reference's (pointer and symbol windows,
    with inactive rows among the real ones)."""
    import torch
    from repro_torch.core.engine.plan import LEGACY_POLICY
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.parallel.decode_shard import (ShardedExecutor,
                                                   shard_row_ranges,
                                                   shard_windows)
    model = StaticModel.from_symbols(np.arange(256), 256,
                                     RansParams(n_bits=11, ways=32))
    ex = ShardedExecutor(model, True, (torch.zeros(2048, dtype=torch.int32),
                                       None, None),
                         mesh=_mesh(n_shards), policy=LEGACY_POLICY)
    rng = np.random.default_rng(n_shards)
    for S in range(1, 301):
        stop = rng.integers(0, 10_000, S)
        start = stop + rng.integers(0, 5_000, S)
        start[rng.random(S) < 0.1] = -1            # inactive real rows
        q0 = rng.integers(5_000, 200_000, S)
        s_b, owner, lo_r, hi_r = _reference_windows(
            start, stop, q0 - (start - stop), q0, S, n_shards)
        assert ex._split_bucket(S) == s_b
        ranges = shard_row_ranges(S, n_shards, s_b // n_shards)
        got = np.concatenate([np.full(b - a, s) for s, (a, b)
                              in enumerate(ranges)]).astype(np.int64)
        np.testing.assert_array_equal(got, owner)
        lo, hi = shard_windows(q0 - (start - stop), q0, start >= 0, ranges)
        np.testing.assert_array_equal(lo, lo_r)
        np.testing.assert_array_equal(hi, hi_r)
        base = rng.integers(0, 100, S) * 32
        _, _, lo_r, hi_r = _reference_windows(start, stop, stop + base,
                                              start + base, S, n_shards)
        lo, hi = shard_windows(stop + base, start + base, start >= 0, ranges)
        np.testing.assert_array_equal(lo, lo_r)
        np.testing.assert_array_equal(hi, hi_r)


@pytest.mark.parametrize("layout", ["symbol", "pointer"])
@in_child
def test_sharded_service_streams_8_chunks(layout):
    """``submit_stream`` in 8 chunks on a sharded service: each chunk equals
    its slice of the symbols and of the unsharded service's, in both
    layouts, and a second round resolves no launcher."""
    import torch
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.runtime.serve import DecodeService
    syms = _exp_symbols(7, 30_000)
    model = StaticModel.from_symbols(syms, 256,
                                     RansParams(n_bits=11, ways=32))
    svc = DecodeService(model, impl="sharded", mesh=_mesh(), layout=layout)
    plain = DecodeService(model, device="cpu", layout=layout)
    for s in (svc, plain):
        s.ingest("a", syms, 64)
    assert svc.layout_for("a") == layout
    want = plain.decode_chunks("a", 64, 8)
    for _round in range(2):
        before = svc.stats.compiles
        t = svc.submit_stream("a", 64, 8)
        parts = [t.chunk(i) for i in range(t.n_chunks)]
        assert len(parts) == 8
        for part, spec, w in zip(parts, t.specs, want):
            np.testing.assert_array_equal(
                part.numpy(), syms[spec.base:spec.base + spec.length])
            assert torch.equal(part, w)
        np.testing.assert_array_equal(t.result().numpy(), syms)
    assert svc.stats.compiles == before
    assert svc.stats.stream_requests == 2


@in_child
def test_decode_mesh_needs_a_card_or_a_device_list():
    """With no card, the default mesh and a sharded session without a mesh
    raise, never drifting to the CPU; an explicit CPU list works."""
    import torch
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.launch.mesh import make_decode_mesh, make_smoke_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model = StaticModel.from_symbols(np.arange(256), 256,
                                     RansParams(n_bits=11, ways=32))
    for build in (make_decode_mesh, make_smoke_mesh,
                  lambda: DecoderSession(model, impl="sharded")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    mesh = make_decode_mesh(devices=CPU4)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert (mesh.axis_names, mesh.shape) == (("shard",), {"shard": 4})
    assert make_decode_mesh(2, devices=CPU4).shape == {"shard": 2}


@in_child
def test_too_many_shards_and_bad_meshes_raise():
    """More shards than devices raises, as ``jax.make_mesh`` does; so do a
    smoke mesh that does not split into its model columns and a mesh whose
    size is not its devices' count."""
    from repro_torch.launch.mesh import (DecodeMesh, make_decode_mesh,
                                         make_smoke_mesh)
    with pytest.raises(ValueError):
        make_decode_mesh(5, devices=CPU4)
    with pytest.raises(ValueError):
        make_decode_mesh(0, devices=CPU4)
    with pytest.raises(ValueError):
        make_smoke_mesh(3, devices=CPU4)
    with pytest.raises(ValueError):
        DecodeMesh(CPU4, ("data", "model"), (2, 3))


@in_child
def test_sharded_session_refuses_a_mismatched_device_or_impl():
    """``device=`` other than the mesh's first device raises, as do a mesh
    without ``impl="sharded"`` and the reference's other impls; the
    sharded keys read ``cpu:sharded:<layout>``."""
    import torch
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.tuning import platform_of
    from repro_torch.runtime.serve import DecodeService
    model = StaticModel.from_symbols(np.arange(256), 256,
                                     RansParams(n_bits=11, ways=32))
    mesh = _mesh()
    with pytest.raises((ValueError, RuntimeError)):
        DecoderSession(model, impl="sharded", mesh=mesh, device="cuda")
    with pytest.raises((ValueError, RuntimeError)):
        DecodeService(model, impl="sharded", mesh=mesh, device="cuda:0")
    with pytest.raises(ValueError, match="mesh"):
        DecoderSession(model, device="cpu", mesh=mesh)
    for impl in ("jnp", "pallas", "cuda"):
        with pytest.raises(ValueError):
            DecoderSession(model, device="cpu", impl=impl)
    with pytest.raises(ValueError):
        platform_of("sharded")
    sess = DecoderSession(model, impl="sharded", mesh=mesh, device="cpu")
    assert sess.device == torch.device("cpu") and sess.impl == "sharded"
    svc = DecodeService(model, impl="sharded", mesh=mesh)
    assert 'impl="sharded"' in svc.metrics_text()

"""The port's checkpoint manager and int8 quantizer against the JAX
package's, on the CPU (``device="cpu"``: the plain torch versions of the
ingest and walk kernels).

Mirrors ``tests/test_train_runtime.py``'s checkpoint tests and holds more:
the quantizer bit-equal to the reference's; both codecs' files byte-equal
to the reference's ``save`` of the same tree (manifest, ``.npy``, ``.rcl``,
``.scale.npy``); each package restoring the other's checkpoint bit-equal at
1, 4 and 64 threads; a corrupted leaf raising ``IOError``; ``keep`` and
``save_async`` as in the reference.  Trees are the reference's ``LM.init``
parameters of a smoke config, carried with ``params_from_arrays``.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.model import LM as JLM
from repro.optim import compress as j_compress


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _trees(dtype="float32", arch="qwen3_4b"):
    """The reference's smoke params as numpy arrays, and the port's copy."""
    from repro_torch.models.convert import params_from_arrays
    jlm = JLM(j_get_smoke_config(arch),
              param_dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    ref = {"params": _np_tree(jlm.init(jax.random.PRNGKey(0)))}
    return ref, params_from_arrays(ref, "cpu")


def _manager(root, **kw):
    from repro_torch.checkpoint.manager import CheckpointManager
    return CheckpointManager(root=root, device="cpu", **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(a):
    """An array's bit pattern (bf16 and float32 compare bit for bit)."""
    import torch
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.cpu().view(torch.int16).numpy()
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for name in fa:
        x, y = _bits(fa[name]), _bits(fb[name])
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 4097, 100_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@in_child
def test_quantize_int8_bit_equal_to_reference(n, dtype):
    import torch
    from repro_torch.optim import compress
    rng = np.random.default_rng(n)
    g = (rng.normal(size=n) * rng.exponential(2.0, size=n)).astype(np.float32)
    if n > 300:
        g[256:512] = 0.0            # an all-zero block: scale 1e-12
    jg = jnp.asarray(g, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jq, js = j_compress.quantize_int8(jg)
    tq, ts = compress.quantize_int8(tg)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = compress.dequantize_int8(tq, ts, (n,), n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_compress.dequantize_int8(jq, js, (n,), n)))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["raw", "recoil"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@in_child
def test_save_writes_the_reference_files(codec, dtype):
    """The manifest and every leaf file byte-equal to the reference's."""
    ref, tree = _trees(dtype)
    with tempfile.TemporaryDirectory() as d:
        jm = JManager(root=os.path.join(d, "ref"), codec=codec,
                      recoil_splits=64)
        tm = _manager(os.path.join(d, "port"), codec=codec, recoil_splits=64)
        jdir, tdir = jm.save(3, ref), tm.save(3, tree)
        want, got = _dir_bytes(jdir), _dir_bytes(tdir)
        assert list(got) == list(want)
        for f in want:
            assert got[f] == want[f], f
        manifest = json.loads(got["manifest.json"])
        kinds = {e["codec"] for e in manifest["leaves"].values()}
        assert kinds == ({"raw", "recoil"} if codec == "recoil" else {"raw"})
        if dtype == "bfloat16" and codec == "raw":
            assert {e.get("stored_as") for e in manifest["leaves"].values()} \
                == {"float32"}


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
@pytest.mark.parametrize("codec", ["raw", "recoil"])
@in_child
def test_family_trees_save_the_reference_files(codec, arch):
    """The SSM and hybrid smoke trees (the SSM leaves, hymba's meta tokens
    and ``mix_*``, the zero ``D`` and ``dt_bias`` leaves) in both dtypes:
    the manifest and every leaf file byte-equal to the reference's."""
    for dtype in ("float32", "bfloat16"):
        ref, tree = _trees(dtype, arch=arch)
        assert {"D", "dt_bias", "A_log"} <= set(tree["params"]["layers"])
        with tempfile.TemporaryDirectory() as d:
            jdir = JManager(root=os.path.join(d, "ref"), codec=codec,
                            recoil_splits=64).save(3, ref)
            tdir = _manager(os.path.join(d, "port"), codec=codec,
                            recoil_splits=64).save(3, tree)
            want, got = _dir_bytes(jdir), _dir_bytes(tdir)
            assert list(got) == list(want)
            for f in want:
                assert got[f] == want[f], f
            manifest = json.loads(got["manifest.json"])["leaves"]
            assert "params/layers/D" in manifest
            if codec == "recoil":
                assert manifest["params/layers/ssm_out"]["codec"] == "recoil"


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
@in_child
def test_family_trees_restore_across_packages(arch):
    """Recoil checkpoints of the SSM and hybrid smoke trees at 64 splits,
    thinned to 4 threads: each package restores the other's bit-equal to
    that package's own restore."""
    for dtype in ("float32", "bfloat16"):
        ref, tree = _trees(dtype, arch=arch)
        with tempfile.TemporaryDirectory() as d:
            jm = JManager(root=os.path.join(d, "ref"), codec="recoil",
                          recoil_splits=64)
            tm = _manager(os.path.join(d, "port"), codec="recoil",
                          recoil_splits=64)
            jm.save(1, ref)
            tm.save(1, tree)
            tportref, _ = _manager(jm.root).restore(n_threads=4)
            _assert_trees_bit_equal(tportref, jm.restore(n_threads=4)[0])
            jport, _ = JManager(root=tm.root).restore(n_threads=4)
            _assert_trees_bit_equal(tm.restore(n_threads=4)[0], jport)


@in_child
def test_planning_range_holds_the_largest_leaf():
    """mamba2_2_7b's ``ssm_in`` (64 x 2560 x 10576 = 1,732,771,840 symbols,
    past the reference's 2^30) lies inside the port's ingest range, which
    keeps N + n_splits (n_splits below the planner's 2^26 slots) and every
    kernel grid below 2^31."""
    from repro_torch.configs import get_config
    from repro_torch.core.encode.session import MAX_SYMBOLS
    cfg = get_config("mamba2_2_7b")
    n = cfg.n_layers * cfg.d_model * (2 * cfg.d_inner + 2 * cfg.ssm_state
                                      + cfg.ssm_heads)
    assert n == 1_732_771_840
    assert 2 ** 30 < n < MAX_SYMBOLS and MAX_SYMBOLS + 2 ** 26 <= 2 ** 31


@pytest.mark.parametrize("threads", [1, 4, 64])
@in_child
def test_each_package_restores_the_others_checkpoint(threads):
    """Recoil checkpoints at 64 splits, thinned to ``threads``: the port's
    restore of the reference's files equals the reference's own restore,
    and the reference's restore of the port's files equals the port's."""
    from repro_torch.models.convert import params_to_arrays
    for dtype in ("float32", "bfloat16"):
        ref, tree = _trees(dtype)
        with tempfile.TemporaryDirectory() as d:
            jm = JManager(root=os.path.join(d, "ref"), codec="recoil",
                          recoil_splits=64)
            tm = _manager(os.path.join(d, "port"), codec="recoil",
                          recoil_splits=64)
            jm.save(1, ref)
            tm.save(1, tree)
            jroot = _manager(jm.root)
            tportref, s = jroot.restore(n_threads=threads)
            jref, _ = jm.restore(n_threads=threads)
            assert s == 1
            _assert_trees_bit_equal(tportref, jref)
            jport, _ = JManager(root=tm.root).restore(n_threads=threads)
            tport, _ = tm.restore(n_threads=threads)
            _assert_trees_bit_equal(tport, jport)
            _assert_trees_bit_equal(params_to_arrays(tport), jport)
            # and within the int8 bound of the parameters
            a = np.asarray(ref["params"]["embed"], np.float32)
            b = tport["params"]["embed"].float().numpy()
            assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 2e-2


@in_child
def test_restore_equals_the_direct_int8_round_trip():
    """Every recoil leaf restores to ``dequantize_int8(quantize_int8(leaf))``
    bit for bit; raw leaves restore exactly."""
    import torch
    from repro_torch.optim.compress import dequantize_int8, quantize_int8
    _, tree = _trees("bfloat16", arch="h2o_danube3_4b")
    with tempfile.TemporaryDirectory() as d:
        tm = _manager(d, codec="recoil", recoil_splits=32)
        tm.save(2, tree)
        manifest = json.load(open(os.path.join(tm._step_dir(2),
                                               "manifest.json")))
        for threads in (0, 7, 32):
            got, _ = tm.restore(2, n_threads=threads)
            for name, leaf in _flat(tree).items():
                entry = manifest["leaves"][name]
                if entry["codec"] == "recoil":
                    q, s = quantize_int8(leaf)
                    want = dequantize_int8(q, s, leaf.shape, leaf.numel()).to(
                        leaf.dtype)
                else:
                    want = leaf
                assert _flat(got)[name].dtype == torch.bfloat16
                np.testing.assert_array_equal(_bits(_flat(got)[name]),
                                              _bits(want), err_msg=name)


@in_child
def test_constant_leaf_round_trips():
    """A leaf whose int8 values are all equal (a norm scale of ones, 4096
    or more of them) cannot be saved by the reference: its one-symbol table
    entry, f = 2^n, does not fit the container's n-bit field.  The port
    keeps f below 2^n with a pseudo-count and restores the leaf.  Such a
    stream holds no word at these sizes (a state grows by about 1/2047 a
    symbol), which the reference's jnp walk cannot index, so the
    reference's side reads the port's container with its own ``parse`` and
    decodes it with its oracle ``decode_recoil``."""
    import torch
    from repro.core import container as j_container
    from repro.core import rans as j_rans
    from repro.core import recoil as j_recoil
    ones = {"ln": torch.ones((8, 640), dtype=torch.bfloat16),
            "w": torch.full((20, 256), -0.25)}
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="do not fit"):
            JManager(root=os.path.join(d, "ref"), codec="recoil").save(
                1, {"ln": np.ones((8, 640), np.float32)})
        tm = _manager(os.path.join(d, "port"), codec="recoil")
        tm.save(1, ones)
        for threads in (0, 1, 16):
            got, _ = tm.restore(n_threads=threads)
            _assert_trees_bit_equal(got, ones)
        for name, sym in (("ln", 254), ("w", 0)):
            buf = open(os.path.join(tm._step_dir(1), name + ".rcl"),
                       "rb").read()
            pc = j_container.parse(buf, j_rans.RansParams(n_bits=11, ways=32))
            assert len(pc.stream) == 0 and pc.model.f[sym] == 2047
            out = j_recoil.decode_recoil(pc.plan, pc.stream,
                                         pc.final_states, pc.model)
            assert (np.asarray(out) == sym).all()


@pytest.mark.parametrize("codec", ["raw", "recoil"])
@in_child
def test_corrupted_leaf_raises(codec):
    ref, tree = _trees()
    with tempfile.TemporaryDirectory() as d:
        tm = _manager(d, codec=codec, keep=2, recoil_splits=16)
        tm.save(5, tree)
        tm.save(9, tree)
        assert tm.latest() == 9
        got, s = tm.restore()
        assert s == 9
        if codec == "raw":
            _assert_trees_bit_equal(got, tree)
        d9 = tm._step_dir(9)
        ext = ".npy" if codec == "raw" else ".rcl"
        victim = next(f for f in sorted(os.listdir(d9))
                      if f.endswith(ext) and not f.endswith(".scale.npy"))
        with open(os.path.join(d9, victim), "r+b") as f:
            f.seek(120)
            f.write(b"\xde\xad")
        with pytest.raises(IOError, match="crc mismatch"):
            tm.restore(9)
        with pytest.raises(IOError):     # and the reference agrees
            JManager(root=d, codec=codec).restore(9)


@in_child
def test_keep_and_save_async_as_the_reference():
    """``keep`` drops the oldest steps; ``save_async`` snapshots the tree
    before its thread starts (a later write to a parameter does not reach
    the file) and writes the manifest the reference's ``save_async`` does
    (its ``jax.tree.map`` snapshot sorts the dict keys)."""
    ref, tree = _trees()
    with tempfile.TemporaryDirectory() as d:
        tm = _manager(os.path.join(d, "port"), codec="raw", keep=2)
        jm = JManager(root=os.path.join(d, "ref"), codec="raw", keep=2)
        for s in (1, 2, 3):
            tm.save_async(s, tree)
            tree["params"]["final_norm"].add_(1.0)
            tm.wait()
            jm.save_async(s, ref)
            ref["params"]["final_norm"] = ref["params"]["final_norm"] + 1.0
            jm.wait()
        for m in (tm, jm):
            assert sorted(int(x.split("_")[1])
                          for x in os.listdir(m.root)) == [2, 3]
        assert _dir_bytes(tm._step_dir(3)) == _dir_bytes(jm._step_dir(3))
        got, _ = tm.restore()
        np.testing.assert_array_equal(
            got["params"]["final_norm"].numpy(),
            tree["params"]["final_norm"].numpy() - 1.0)


@in_child
def test_save_async_error_reaches_wait():
    with tempfile.TemporaryDirectory() as d:
        tm = _manager(d, codec="raw")
        tm.save_async(1, {"bad": "not an array"})
        with pytest.raises(TypeError):
            tm.wait()
        tm.wait()                                        # reported once


@in_child
def test_ingest_and_walk_serve_every_recoil_leaf():
    """On the CPU the plain versions of the kernels serve: one encode scan
    and one planner call a recoil leaf saved, one pointer walk a recoil
    leaf restored (a container off disk has no emission log)."""
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.kernels.rans_encode import rans_encode as re_
    _, tree = _trees()
    with tempfile.TemporaryDirectory() as d:
        tm = _manager(d, codec="recoil", recoil_splits=64)
        re_.reset_counts()
        rd.reset_counts()
        tm.save(1, tree)
        manifest = json.load(open(os.path.join(tm._step_dir(1),
                                               "manifest.json")))
        n = sum(e["codec"] == "recoil" for e in manifest["leaves"].values())
        assert n >= 5
        assert re_.encode_scan.plain_calls == n
        assert re_.plan_splits.plain_calls == n
        assert re_.encode_scan.launches == re_.plan_splits.launches == 0
        tm.restore(n_threads=8)
        assert rd.walk_decode_pointer.plain_calls == n
        assert rd.walk_decode_symbol.plain_calls == 0
        assert rd.walk_decode_pointer.launches == 0


@pytest.mark.parametrize("codec", ["raw", "recoil"])
@in_child
def test_train_state_save_async_writes_the_reference_files(codec):
    """A ``{params, opt}`` train state (bf16 params, float32 moments, the
    int32 ``count``) after one reference train step, saved through
    ``save_async``: the manifest and every leaf file byte-equal to the
    reference's ``save_async`` of the same state, and restored bit-equal
    to the reference's restore."""
    from repro.optim.schedule import constant
    from repro.runtime.train import init_state, make_train_step
    from repro_torch.models.convert import params_from_arrays
    jlm = JLM(j_get_smoke_config("granite_3_2b"), param_dtype=jnp.bfloat16)
    js = init_state(jlm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, jlm.cfg.vocab, (4, 16))
    js, _ = jax.jit(make_train_step(jlm.loss, constant(1e-3)))(
        js, {"tokens": jnp.asarray(toks, jnp.int32)})
    ref = {"params": _np_tree(js.params), "opt": _np_tree(js.opt)}
    tree = params_from_arrays(ref, "cpu")
    assert not tree["opt"]["count"].is_floating_point()
    with tempfile.TemporaryDirectory() as d:
        jm = JManager(root=os.path.join(d, "ref"), codec=codec,
                      recoil_splits=64)
        tm = _manager(os.path.join(d, "port"), codec=codec, recoil_splits=64)
        jm.save_async(2, ref)
        tm.save_async(2, tree)
        for leaf in _flat(tree).values():   # after the snapshot: unseen
            leaf.zero_()
        jm.wait()
        tm.wait()
        want, got = _dir_bytes(jm._step_dir(2)), _dir_bytes(tm._step_dir(2))
        assert list(got) == list(want)
        for f in want:
            assert got[f] == want[f], f
        manifest = json.loads(got["manifest.json"])["leaves"]
        assert manifest["opt/count"]["dtype"] == "int32"
        assert manifest["opt/m/embed"]["dtype"] == "float32"
        assert manifest["params/embed"]["dtype"] == "bfloat16"
        _assert_trees_bit_equal(tm.restore(n_threads=4)[0],
                                jm.restore(n_threads=4)[0])

"""The port's training path (``optim/``, ``runtime/train.py``,
``runtime/fault.py``) against the JAX package's, on the CPU.

Inputs come from numpy seeds; the reference's params come from its own
``LM.init`` and cross with ``params_from_arrays``.  Tolerances, stated once:

  * schedules: 1e-7 relative (both compute the same float32 formulas; the
    cosine is rounded from float64, as the reference's correctly rounded
    float32 cosine gives it);
  * AdamW: 1e-6 relative (the same float32 operations; the norm's sums run
    in each library's own order);
  * compression: bit-equal (quantization and the error feedback are exact
    float32 operations in one order);
  * train steps over 3 steps: every param leaf within 1e-4 of its max |value|
    (the loss and gradients of two float32 libraries agree to about 1e-6,
    and AdamW's normalized steps carry that through);
  * the cross-pod step: the pod copies bit-equal; each pod's gradients
    within 1e-4 of ``jax.value_and_grad``'s; given those gradients, the EF
    residuals bit-equal to the reference pieces' and params and moments
    within 1e-6 relative.

The reference's own cross-pod test fails on the installed jax, so the
cross-pod step is held against the reference's pieces: ``jax.value_and_grad``
per pod, ``quantize_int8``, the ``sum(q * s) / n_pods`` mean and
``apply_adamw``.  The ten architectures' losses and gradients, and the remat
policies, are held in ``tests/test_torch_grads.py``.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus
from repro.models.model import LM as JLM
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import schedule as j_schedule
from repro.runtime import train as j_train

ADAMW_RTOL = 1e-6
STEP_TOL = 1e-4


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-30))


def _f32(t):
    return t.detach().float().numpy()


def _setup(accum=1, arch="granite_3_2b"):
    """The reference test's setup: a smoke LM at float32, its params, and
    the port's LM with the same params."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.models.model import LM
    jlm = JLM(j_get_smoke_config(arch), param_dtype=jnp.float32)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(get_smoke_config(arch), param_dtype=torch.float32)
    return jlm, jparams, tlm, params_from_arrays(_np_tree(jparams), "cpu")


def _batches(vocab, n, batch=8, seq=32):
    data = JSyntheticCorpus(JDataConfig(vocab=vocab, seq_len=seq,
                                        global_batch=batch))
    return [data.batch(t)["tokens"] for t in range(n)]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(1e-3, 10, 100), (3e-4, 20, 120),
                                  (3e-4, 2, 5), (1e-3, 0, 50)])
@in_child
def test_schedules_equal_reference(args):
    import torch
    from repro_torch.optim import schedule
    steps = range(121)
    want = np.array([float(j_schedule.cosine_with_warmup(*args)(s))
                     for s in steps], np.float32)
    sched = schedule.cosine_with_warmup(*args)
    for got in ([sched(s) for s in steps],
                [sched(torch.tensor(s, dtype=torch.int32)) for s in steps]):
        assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
        got = np.array([float(g) for g in got], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    c = schedule.constant(args[0])(torch.tensor(3))
    assert c.dtype == torch.float32 and float(c) == float(
        j_schedule.constant(args[0])(3))


@in_child
def test_schedule_shapes():
    """The reference's ``test_schedule_shapes`` on the port."""
    from repro_torch.optim.schedule import cosine_with_warmup
    sched = cosine_with_warmup(1e-3, 10, 100)
    assert float(sched(0)) == 0.0
    assert abs(float(sched(10)) - 1e-3) < 1e-9
    assert float(sched(100)) < float(sched(50)) < float(sched(10))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_tree(rng, dtype):
    return {"b": {"w": rng.normal(size=(40, 33)).astype(dtype),
                  "z": rng.normal(size=(7,)).astype(dtype)},
            "a": rng.normal(size=(300,)).astype(dtype),
            "c": {"k": rng.normal(size=(3, 4, 5)).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,gscale", [(1.0, 1.0), (1.0, 1e-3),
                                         (0.0, 1.0)])
@in_child
def test_adamw_equals_reference(dtype, clip, gscale):
    """``init_moments``, ``global_norm`` and three ``apply_adamw`` steps
    (the clip engaged at gscale 1, not at 1e-3, off at clip 0), the second
    in place, within 1e-6 relative; leaves in the reference's order."""
    import torch
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.optim import adamw
    np_dt = np.float32 if dtype == "float32" else jnp.bfloat16
    rng = np.random.default_rng(0)
    params = _adam_tree(rng, np_dt)
    grads0 = _adam_tree(rng, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jo = j_adamw.init_moments(jp)
    tp = params_from_arrays(params, "cpu")
    to = adamw.init_moments(tp)
    assert [(k, v.dtype) for k, v in zip(
        ["m"] * 4, adamw.tree_leaves(to["m"]))] == [
        ("m", torch.float32)] * 4
    assert to["count"].dtype == torch.int32 and int(to["count"]) == 0
    jcfg = j_adamw.AdamWConfig(grad_clip=clip)
    tcfg = adamw.AdamWConfig(grad_clip=clip)
    for it in range(3):
        g = jax.tree.map(lambda a: (a * gscale * (it + 1)).astype(np_dt),
                         grads0)
        tg = params_from_arrays(g, "cpu")
        assert abs(float(adamw.global_norm(tg))
                   - float(j_adamw.global_norm(g))) <= ADAMW_RTOL * float(
            j_adamw.global_norm(g))
        jp, jo, jm = j_adamw.apply_adamw(jp, jax.tree.map(jnp.asarray, g),
                                         jo, jnp.float32(1e-3), jcfg)
        tp, to, tm = adamw.apply_adamw(tp, tg, to, torch.tensor(1e-3), tcfg,
                                       inplace=it == 1)
        assert _rel(jm["grad_norm"], float(tm["grad_norm"])) < ADAMW_RTOL
    assert int(to["count"]) == 3
    assert list(tp) == list(params) and list(tp["b"]) == ["w", "z"]
    for tree_t, tree_j in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for t, j in zip(adamw.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel(j, _f32(t)) < ADAMW_RTOL
    assert [str(t.dtype) for t in adamw.tree_leaves(tp)] == [
        f"torch.{dtype}"] * 4


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@in_child
def test_compression_bit_equal_to_reference():
    """``compress_decompress`` (with and without the leading pod-block
    axis) and ``compress_tree`` with error feedback, 5 rounds, bit-equal;
    ``init_error_feedback`` and ``compressed_bytes_ratio`` equal."""
    import torch
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.optim import compress
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(4097,)).astype(np.float32),
            "l": {"a": (rng.normal(size=(33, 17)) * 1e-3).astype(np.float32),
                  "b": rng.normal(size=(256,)).astype(np.float32)}}
    j_ef = j_compress.init_error_feedback(tree)
    t_ef = compress.init_error_feedback(params_from_arrays(tree, "cpu"))
    for pods in (0, 2):
        lead = compress.init_error_feedback(params_from_arrays(tree, "cpu"),
                                            pods)
        want = j_compress.init_error_feedback(tree, pods)
        for t, j in zip(compress.tree_leaves(lead), jax.tree.leaves(want)):
            assert tuple(t.shape) == j.shape and not t.any()
    for r in range(5):
        g = jax.tree.map(lambda a: (a * (r + 1)).astype(np.float32), tree)
        jh, j_ef = j_compress.compress_tree(jax.tree.map(jnp.asarray, g),
                                            j_ef, None)
        th, t_ef = compress.compress_tree(params_from_arrays(g, "cpu"), t_ef)
        for a, b in ((th, jh), (t_ef, j_ef)):
            for t, j in zip(compress.tree_leaves(a), jax.tree.leaves(b)):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g = rng.normal(size=(2, 300)).astype(np.float32)
    ef = np.zeros((1, 2, 300), np.float32)
    jh, jef = j_compress.compress_decompress(jnp.asarray(g), jnp.asarray(ef),
                                             None)
    th, tef = compress.compress_decompress(torch.from_numpy(g),
                                           torch.from_numpy(ef))
    assert tuple(tef.shape) == (1, 2, 300)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tef.numpy(), np.asarray(jef))
    assert compress.compressed_bytes_ratio(params_from_arrays(tree, "cpu")) \
        == j_compress.compressed_bytes_ratio(tree)


@in_child
def test_compress_error_feedback_converges():
    """The reference's ``test_compress_error_feedback_converges`` on the
    port."""
    import torch
    from repro_torch.optim import compress
    g = {"w": torch.full((512,), 0.003, dtype=torch.float32)}
    ef = compress.init_error_feedback(g)
    acc = torch.zeros((512,))
    for _ in range(50):
        gh, ef = compress.compress_tree(g, ef)
        acc = acc + gh["w"]
    np.testing.assert_allclose((acc / 50).numpy(), 0.003, rtol=2e-2)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@in_child
def test_train_step_equals_reference(accum):
    """``make_train_step`` with accumulation 1 and 2, 3 steps of the
    cosine schedule from the same params and batches: metrics and every
    param leaf against the reference's jitted step."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import cosine_with_warmup
    from repro_torch.runtime.train import init_state, make_train_step
    jlm, jparams, tlm, tparams = _setup()
    jstep = jax.jit(j_train.make_train_step(
        jlm.loss, j_schedule.cosine_with_warmup(1e-3, 1, 3),
        accum_steps=accum))
    tstep = make_train_step(tlm.loss, cosine_with_warmup(1e-3, 1, 3),
                            accum_steps=accum)
    js, ts = j_train.init_state(jparams), init_state(tparams)
    for toks in _batches(jlm.cfg.vocab, 3):
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": toks})
        assert sorted(tm) == sorted(jm)
        assert all(v.dim() == 0 for v in tm.values())
        for k in ("loss", "grad_norm"):
            assert _rel(jm[k], float(tm[k])) < STEP_TOL, k
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["step"]) == float(jm["step"])
    assert int(ts.step) == 3 and int(ts.opt["count"]) == 3
    for t, j in zip(adamw.tree_leaves(ts.params), jax.tree.leaves(js.params)):
        np.testing.assert_allclose(_f32(t), np.asarray(j), rtol=0,
                                   atol=STEP_TOL * np.abs(j).max())
    assert ts.params["embed"].dtype == torch.float32


@in_child
def test_loss_decreases():
    """The reference's ``test_loss_decreases`` on the port."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train import init_state, make_train_step
    _, _, tlm, params = _setup()
    step = make_train_step(tlm.loss, constant(1e-3))
    data = SyntheticCorpus(DataConfig(vocab=tlm.cfg.vocab, seq_len=32,
                                      global_batch=8))
    state = init_state(params)
    losses = []
    for t in range(10):
        state, m = step(state, {"tokens": data.batch(t)["tokens"]})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert float(m["grad_norm"]) > 0


@in_child
def test_grad_accumulation_equivalence():
    """The reference's ``test_grad_accumulation_equivalence`` on the port:
    accum=2 over one batch == accum=1."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.optim.adamw import global_norm, tree_map
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train import init_state, make_train_step
    _, _, tlm, params = _setup()
    data = SyntheticCorpus(DataConfig(vocab=tlm.cfg.vocab, seq_len=32,
                                      global_batch=8))
    batch = {"tokens": torch.from_numpy(data.batch(0)["tokens"])}
    s1, m1 = make_train_step(tlm.loss, constant(1e-3), accum_steps=1)(
        init_state(params), batch)
    s2, m2 = make_train_step(tlm.loss, constant(1e-3), accum_steps=2)(
        init_state(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    diff = global_norm(tree_map(lambda a, b: a - b, s1.params, s2.params))
    assert float(diff) < 1e-3


@in_child
def test_donated_step_equals_the_functional_step():
    """``donate=True`` writes the new params and moments into the state it
    was given, bit-equal to the functional step's new tensors."""
    import torch
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train import init_state, make_train_step
    _, _, tlm, params = _setup()
    batch = {"tokens": _batches(tlm.cfg.vocab, 1)[0]}
    fresh = lambda: init_state(tree_map(torch.clone, params))  # noqa: E731
    s1, _ = make_train_step(tlm.loss, constant(1e-3), accum_steps=2)(
        fresh(), batch)
    given = fresh()
    s2, _ = make_train_step(tlm.loss, constant(1e-3), accum_steps=2,
                            donate=True)(given, batch)
    for a, b, c in zip(tree_leaves(s1.params), tree_leaves(s2.params),
                       tree_leaves(given.params)):
        assert torch.equal(a, b) and b.data_ptr() == c.data_ptr()
    for a, b in zip(tree_leaves(s1.opt), tree_leaves(s2.opt)):
        assert torch.equal(a, b)
    for v in params.values():   # the caller's params are untouched
        assert not isinstance(v, torch.Tensor) or v.data_ptr() not in {
            t.data_ptr() for t in tree_leaves(s2.params)}


@in_child
def test_state_carries_across():
    """``state_from_arrays`` carries a reference ``TrainState`` (params,
    moments, count, step and EF after a step) bit for bit."""
    from repro_torch.models.convert import state_from_arrays
    from repro_torch.optim.adamw import tree_leaves
    jlm, jparams, _, _ = _setup()
    js = j_train.init_state(jparams, compress=True)
    js, _ = jax.jit(j_train.make_train_step(
        jlm.loss, j_schedule.constant(1e-3)))(
        js, {"tokens": jnp.asarray(_batches(jlm.cfg.vocab, 1)[0])})
    host = j_train.TrainState(params=_np_tree(js.params),
                              opt=_np_tree(js.opt), step=np.asarray(js.step),
                              ef=_np_tree(js.ef))
    ts = state_from_arrays(host, "cpu")
    assert int(ts.step) == 1 and int(ts.opt["count"]) == 1
    for part in ("params", "opt", "ef"):
        got = tree_leaves(getattr(ts, part))
        want = jax.tree.leaves(getattr(host, part))
        assert len(got) == len(want)
        for t, j in zip(got, want):
            np.testing.assert_array_equal(t.numpy(), j)


# ---------------------------------------------------------------------------
# the cross-pod compressed step
# ---------------------------------------------------------------------------

def _reference_crosspod(params, opt, ef, grads, lr):
    """One cross-pod step from the reference's functions, given each pod's
    gradients: EF + ``quantize_int8``, the ``sum(q * s) / n_pods`` mean over
    the pods, ``apply_adamw``.  Returns (params, opt, ef)."""
    n_pods = len(grads)
    tdef = jax.tree.structure(params)
    sent = []
    for g, e in zip(grads, ef):
        leaves = []
        for gl, el in zip(jax.tree.leaves(g), jax.tree.leaves(e)):
            gq_in = gl.astype(jnp.float32) + el
            q, s = j_compress.quantize_int8(gq_in)
            leaves.append((q, s, gq_in - j_compress.dequantize_int8(
                q, s, gl.shape, gl.size), gl))
        sent.append(leaves)
    g_hat = []
    for k, (_, _, _, gl) in enumerate(sent[0]):
        q_all = jnp.stack([sent[p][k][0] for p in range(n_pods)])
        s_all = jnp.stack([sent[p][k][1] for p in range(n_pods)])
        acc = jnp.sum(q_all.astype(jnp.float32) * s_all, axis=0) / n_pods
        g_hat.append(acc.reshape(-1)[:gl.size].reshape(gl.shape)
                     .astype(gl.dtype))
    params, opt, _ = j_adamw.apply_adamw(
        params, jax.tree.unflatten(tdef, g_hat), opt, jnp.float32(lr),
        j_adamw.AdamWConfig())
    return params, opt, [jax.tree.unflatten(tdef, [x[2] for x in leaves])
                         for leaves in sent]


@in_child
def test_crosspod_step_equals_reference_pieces():
    """The cross-pod compressed step on a ``("cpu",) * 2`` pod mesh, 3
    steps: the pod copies bit-equal after every step and the loss falling.
    Against the reference: each pod's loss and gradients (the port's
    ``value_and_grad`` on the pod's rows, which the step runs) within 1e-4 of
    ``jax.value_and_grad`` at the first step, where the params are the
    same; and, given those gradients, the same step built from reference
    pieces, whose EF residuals must be bit-equal to the pods' and whose
    params and moments must agree within 1e-6 relative.  (Held end to end
    instead, a gradient that differs in its last bits may flip one int8
    level, and AdamW's normalized step then moves that one weight by up to
    the learning rate.)"""
    import torch
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models.convert import params_to_arrays
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train import (init_state,
                                           make_compressed_crosspod_step,
                                           podify_state, value_and_grad)
    jlm, jparams, tlm, tparams = _setup()
    mesh = make_pod_mesh(devices=("cpu",) * 2)
    assert mesh.axis_names == ("pod",) and mesh.shape == {"pod": 2}
    pods = podify_state(init_state(tparams), mesh)
    step = make_compressed_crosspod_step(tlm.loss, constant(1e-3), mesh)
    jp, jo = jparams, j_adamw.init_moments(jparams)
    jef = [j_compress.init_error_feedback(jparams)] * 2
    vg = jax.jit(jax.value_and_grad(jlm.loss))
    losses = []
    for t, toks in enumerate(_batches(jlm.cfg.vocab, 3)):
        rows = np.split(toks, 2)
        port = [value_and_grad(tlm.loss, pods[p].params,
                               {"tokens": torch.from_numpy(rows[p])})
                for p in range(2)]
        if t == 0:
            for p in range(2):
                jl, jg = vg(jparams, {"tokens": jnp.asarray(rows[p])})
                assert _rel(jl, float(port[p][0])) < STEP_TOL
                for a, b in zip(tree_leaves(port[p][1]), jax.tree.leaves(jg)):
                    assert _rel(b, _f32(a)) < STEP_TOL
        pods, m = step(pods, {"tokens": toks})
        losses.append(float(m["loss"]))
        assert float(m["loss"]) == float((port[0][0] + port[1][0]) / 2)
        for part in ("params", "opt"):
            for a, b in zip(tree_leaves(getattr(pods[0], part)),
                            tree_leaves(getattr(pods[1], part))):
                assert torch.equal(a, b), part
        jp, jo, jef = _reference_crosspod(
            jp, jo, jef, [jax.tree.map(jnp.asarray,
                                       params_to_arrays(g)) for _, g in port],
            1e-3)
        for p in range(2):
            for a, b in zip(tree_leaves(pods[p].ef), jax.tree.leaves(jef[p])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(pods[0].params), jax.tree.leaves(jp)):
            assert _rel(b, _f32(a)) < ADAMW_RTOL
        for a, b in zip(tree_leaves(pods[0].opt), jax.tree.leaves(jo)):
            assert _rel(b, _f32(a)) < ADAMW_RTOL
        # the reference pieces run on the pods' params from here on
        jp = jax.tree.map(jnp.asarray, params_to_arrays(pods[0].params))
    assert losses[-1] < losses[0], losses
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(pods[0].ef), tree_leaves(pods[1].ef)))


# ---------------------------------------------------------------------------
# fault tolerance (runtime/fault.py, a copy: tests/test_torch_host.py)
# ---------------------------------------------------------------------------

@in_child
def test_preemption_guard():
    from repro_torch.runtime import fault
    with fault.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.preempted


@in_child
def test_straggler_monitor():
    from repro_torch.runtime import fault
    mon = fault.StragglerMonitor(n_hosts=8, windows=3)
    for _ in range(6):
        times = [100.0] * 8
        times[5] = 400.0  # persistent straggler
        reports = mon.observe(times)
    assert any(r.host == 5 for r in reports)
    mon2 = fault.StragglerMonitor(n_hosts=4, windows=2)
    mon2.observe([100, 100, 100, 500])
    for _ in range(20):
        reports = mon2.observe([100, 100, 100, 100])
    assert not reports


@in_child
def test_elastic_mesh_shape():
    from repro_torch.runtime import fault
    assert fault.elastic_mesh_shape(512, 16, pod_size=256) == (2, 16, 16)
    assert fault.elastic_mesh_shape(384, 16, pod_size=256) == (1, 16, 16)
    assert fault.elastic_mesh_shape(192, 16) == (1, 12, 16)
    with pytest.raises(ValueError):
        fault.elastic_mesh_shape(8, 16)


@in_child
def test_run_with_retries_restores_a_train_state():
    """The reference's ``test_run_with_retries``, then the wrapper around
    the port's train step: two transient failures, each followed by a
    restore, and the step's result equal to an unwrapped step's."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime import fault
    from repro_torch.runtime.train import init_state, make_train_step
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return state + 1, {}

    wrapped = fault.run_with_retries(flaky, restore_fn=lambda: 0,
                                     max_retries=3)
    state, _ = wrapped(0, None)
    assert state == 1 and calls["n"] == 3

    _, _, tlm, params = _setup()
    step = make_train_step(tlm.loss, constant(1e-3))
    batch = {"tokens": _batches(tlm.cfg.vocab, 1)[0]}
    fails = {"n": 0}

    def failing_step(state, b):
        fails["n"] += 1
        if fails["n"] <= 2:
            raise RuntimeError("transient")
        return step(state, b)
    restores = []
    got, _ = fault.run_with_retries(
        failing_step, restore_fn=lambda: restores.append(1) or init_state(
            params), max_retries=3)(init_state(params), batch)
    want, _ = step(init_state(params), batch)
    assert len(restores) == 2
    for a, b in zip(tree_leaves(got.params), tree_leaves(want.params)):
        assert torch.equal(a, b)

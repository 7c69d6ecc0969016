"""The port's SSM, MoE, hybrid and encoder-decoder pieces against the JAX
package's, on the CPU.

``repro_torch.models.ssm`` (``segsum``, ``ssd_chunked``, ``ssd_decode_step``,
``causal_conv``) and ``repro_torch.models.moe`` (``moe_ffn``,
``_grouped_moe_ffn``) on the same numpy inputs as the reference's
functions; then the ``LM`` paths these families add: mamba2's
``ssm_split_proj`` variant, the cache's logical axes for all ten
architectures, hymba decoding past its window with meta tokens, and bf16
parameters of mamba2 and grok.  Parameters are the reference's ``LM.init``
carried with ``params_from_arrays``.

Tolerances, stated once:

  * float32 SSD and conv, ``1e-5``: both packages compute the same float32
    operations; the port's pairwise products sum in another order than the
    reference's einsums (values of order 1 to 10);
  * the chunked form against the recurrence, ``atol=2e-4, rtol=1e-3``: the
    reference's own test of the duality;
  * float32 MoE, ``1e-5``: the same products, gathered and combined in the
    reference's order;
  * the LM at float32, ``2e-4``: the reference's serving tolerance;
  * bf16 parameters, ``0.05``: every product and elementwise operation
    rounds to bf16 (a relative step of 2^-8) in an order each package
    chooses, about a dozen such steps at a logit of magnitude 1;
  * mamba2 at full width and 2 layers in bf16, ``0.0625``: two bf16 steps
    at its logits' magnitude (4 to 8, a step of 2^-5), with the port's
    decode-against-forward drift at most twice the reference's
    (``torch_drift.py``).

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models.model import LM as JLM

TOL = 1e-5
ATOL = 2e-4
BF16_ATOL = 0.05


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _t(*arrays):
    import torch
    return [None if a is None else torch.from_numpy(np.asarray(a))
            for a in arrays]


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


def _pair(arch, bf16=False, **replace):
    """(reference LM, its params, port LM, the same params in torch)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.models.model import LM
    jcfg = dataclasses.replace(j_get_smoke_config(arch), **replace)
    tcfg = dataclasses.replace(get_smoke_config(arch), **replace)
    jlm = JLM(jcfg, param_dtype=jnp.bfloat16 if bf16 else jnp.float32,
              kv_cache_dtype="bf16")
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tcfg, param_dtype=torch.bfloat16 if bf16 else torch.float32,
             kv_cache_dtype="bf16")
    return jlm, jparams, tlm, params_from_arrays(_np_tree(jparams), "cpu")


def _ssd_inputs(B=2, S=100, H=4, P=16, N=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _serve_against_reference(jlm, jp, tlm, tp, toks, S, atol):
    """prefill then decode steps over ``toks[:, S:]``: logits within
    ``atol`` of the reference's and, for float32 parameters, every float32
    cache leaf too (with bf16 parameters the float32 SSM state sums bf16
    inputs over the steps; the logits carry the check)."""
    import torch
    lg, cache = tlm.prefill(tp, toks[:, :S])
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :S])
    _close(lg, jlg, atol)
    step = jax.jit(jlm.decode_step)
    for t in range(toks.shape[1] - S):
        nxt = toks[:, S + t:S + t + 1]
        lg, cache = tlm.decode_step(tp, cache, torch.from_numpy(nxt))
        jlg, jcache = step(jp, jcache, nxt)
        _close(lg, jlg, atol)
    assert sorted(cache) == sorted(jcache)
    assert cache["pos"] == int(jcache["pos"])
    if tlm.param_dtype == torch.float32:
        for name, leaf in cache.items():
            if name != "pos" and leaf.dtype == torch.float32:
                _close(leaf, jcache[name], atol)
    return cache


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------

@in_child
def test_segsum_matches_reference():
    import torch
    from repro_torch.models import ssm
    log_a = -np.abs(np.random.default_rng(1).normal(
        size=(2, 3, 16))).astype(np.float32)
    got = ssm.segsum(torch.from_numpy(log_a)).numpy()
    want = np.asarray(j_ssm.segsum(log_a))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=TOL, rtol=0)
    assert (got[~fin] < 0).all()


@pytest.mark.parametrize("S", [100, 128])
@pytest.mark.parametrize("with_h0", [False, True])
@in_child
def test_ssd_chunked_matches_reference(S, with_h0):
    """S = 100 is not a multiple of the chunk (32 here): the padding must
    leave the last state as the reference's."""
    from repro_torch.models import ssm
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S=S)
    h0 = h0 if with_h0 else None
    y, h = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), h0=_t(h0)[0], chunk=32)
    jy, jh = j_ssm.ssd_chunked(x, dt, A, Bm, Cm, h0=h0, chunk=32)
    assert y.shape == (2, S, 4, 16) and h.shape == (2, 4, 16, 8)
    _close(y, jy, TOL, 1e-5)
    _close(h, jh, TOL, 1e-5)
    # the full 128-token chunk, the module default, too
    y2, h2 = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), h0=_t(h0)[0])
    jy2, jh2 = j_ssm.ssd_chunked(x, dt, A, Bm, Cm, h0=h0)
    _close(y2, jy2, TOL, 1e-5)
    _close(h2, jh2, TOL, 1e-5)


@in_child
def test_ssd_decode_step_matches_reference():
    from repro_torch.models import ssm
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S=1)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    y, h = ssm.ssd_decode_step(*_t(*args))
    jy, jh = j_ssm.ssd_decode_step(*args)
    _close(y, jy, TOL)
    _close(h, jh, TOL)


@pytest.mark.parametrize("form", ["full", "cached"])
@in_child
def test_causal_conv_matches_reference(form):
    from repro_torch.models import ssm
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    if form == "full":
        x = rng.normal(size=(2, 9, 24)).astype(np.float32)
        y, tail = ssm.causal_conv(*_t(x, w))
        jy, jtail = j_ssm.causal_conv(x, w)
    else:
        x = rng.normal(size=(2, 1, 24)).astype(np.float32)
        cache = rng.normal(size=(2, 3, 24)).astype(np.float32)
        y, tail = ssm.causal_conv(*_t(x, w), cache=_t(cache)[0])
        jy, jtail = j_ssm.causal_conv(x, w, cache=cache)
    _close(y, jy, TOL)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))


@in_child
def test_mamba2_chunked_vs_decode_recurrence():
    """The port's twin of the reference's test of the same name: the chunked
    form equals the recurrent decode path (SSD duality)."""
    import torch
    from repro_torch.models import ssm
    x, dt, A, Bm, Cm, _ = _ssd_inputs(S=96, seed=0)
    x, dt, A, Bm, Cm = _t(x, dt, A, Bm, Cm)
    y_chunk, h_chunk = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=32)
    h = torch.zeros((2, 4, 16, 8))
    ys = []
    for t in range(96):
        y, h = ssm.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                   h)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), atol=2e-4,
                               rtol=1e-3)


@in_child
def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every magnitude;
    ``F.softplus`` switches to ``x`` above 20 (a different rounding)."""
    from repro_torch.models import ssm
    x = np.array([-40, -3, 0, 0.5, 19.9, 20.1, 25, 60], np.float32)
    np.testing.assert_array_equal(ssm.softplus(_t(x)[0]).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------

def _moe_weights(E=4, d=16, ff=32, seed=3, zero_router=False):
    rng = np.random.default_rng(seed)
    wr = np.zeros((d, E), np.float32) if zero_router else \
        (rng.normal(size=(d, E)) * 0.3).astype(np.float32)
    wg, wi = ((rng.normal(size=(E, d, ff)) * 0.1).astype(np.float32)
              for _ in range(2))
    wo = (rng.normal(size=(E, ff, d)) * 0.1).astype(np.float32)
    return wr, wg, wi, wo


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dropless", [False, True])
@in_child
def test_moe_ffn_matches_reference(top_k, dropless):
    """Capacity 1 / top_k (T / E slots an expert in each top-k pass) drops
    tokens (the test checks that some are); dropless keeps every one."""
    from repro_torch.models import moe
    x = np.random.default_rng(4).normal(size=(2, 32, 16)).astype(np.float32)
    w = _moe_weights()
    kw = dict(top_k=top_k, capacity_factor=1.0 / top_k, dropless=dropless)
    got = moe.moe_ffn(*_t(x, *w), **kw)
    _close(got, j_moe.moe_ffn(x, *w, **kw), TOL)
    if not dropless:
        free = moe.moe_ffn(*_t(x, *w), top_k=top_k, capacity_factor=4.0)
        assert not np.allclose(got.numpy(), free.numpy(), atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
@in_child
def test_grouped_moe_ffn_matches_reference(top_k):
    from repro_torch.models import moe
    x = np.random.default_rng(5).normal(size=(2, 24, 16)).astype(np.float32)
    w = _moe_weights(seed=6)
    kw = dict(top_k=top_k, capacity_factor=1.25, groups=4)
    got = moe.moe_ffn(*_t(x, *w), **kw)
    _close(got, j_moe.moe_ffn(x, *w, **kw), TOL)
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(*_t(x, *w), top_k=top_k, capacity_factor=1.0, groups=5)


@pytest.mark.parametrize("top_k", [1, 2])
@in_child
def test_moe_ties_pick_the_lower_experts(top_k):
    """A zero router ties every logit: the reference's ``lax.top_k`` picks
    experts 0..k-1, and so must the port, capped, dropless and grouped."""
    import torch
    from repro_torch.models import moe
    x = np.random.default_rng(7).normal(size=(2, 8, 16)).astype(np.float32)
    w = _moe_weights(zero_router=True)
    vals, idx = moe.select_top_k(torch.zeros((5, 4)), top_k)
    assert idx.tolist() == [list(range(top_k))] * 5
    jv, ji = jax.lax.top_k(jnp.zeros((5, 4)), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    for kw in (dict(capacity_factor=1.0), dict(capacity_factor=1.0,
                                               dropless=True),
               dict(capacity_factor=2.0, groups=2)):
        got = moe.moe_ffn(*_t(x, *w), top_k=top_k, **kw)
        _close(got, j_moe.moe_ffn(x, *w, top_k=top_k, **kw), TOL)


@in_child
def test_unknown_family_raises():
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_smoke_config("qwen3_4b"), family="conv")
    with pytest.raises(ValueError, match="unknown family"):
        LM(cfg, param_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the LM's new paths
# ---------------------------------------------------------------------------

@in_child
def test_ssm_split_proj_matches_reference():
    """mamba2's ``ssm_split_proj=True`` variant (separate z/x/BC/dt
    projections and split convs): its keys, forward, prefill and decode."""
    jlm, jp, tlm, tp = _pair("mamba2_2_7b", ssm_split_proj=True)
    assert list(tp["layers"]) == list(jp["layers"])
    assert "ssm_wz" in tp["layers"] and "ssm_in" not in tp["layers"]
    toks = np.random.default_rng(8).integers(
        0, jlm.cfg.vocab, (2, 43)).astype(np.int32)
    _close(tlm.forward(tp, toks), jlm.forward(jp, toks), ATOL)
    cache = _serve_against_reference(jlm, jp, tlm, tp, toks, 40, ATOL)
    assert {"conv_x", "conv_bc", "ssm_h"} <= set(cache)
    assert "k" not in cache


@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_cache_specs_match_reference(arch):
    """``cache_specs`` equals the reference's for the smoke and the full
    config (and the full config's LM builds), and names exactly the leaves
    of ``init_cache``, whose shapes and dtypes are the reference's."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import LM
    for t_cfg, j_cfg in ((get_config(arch), j_get_config(arch)),
                         (get_smoke_config(arch), j_get_smoke_config(arch))):
        tlm = LM(t_cfg)
        assert tlm.cache_specs() == JLM(j_cfg).cache_specs()
    tlm = LM(get_smoke_config(arch), param_dtype=torch.float32)
    jlm = JLM(j_get_smoke_config(arch), param_dtype=jnp.float32)
    cache = tlm.init_cache(2, 40, device="cpu")
    jcache = jlm.init_cache(2, 40)
    assert sorted(cache) == sorted(jcache) == sorted(tlm.cache_specs())
    for name, leaf in cache.items():
        if name == "pos":
            assert leaf == 0
            continue
        assert tuple(leaf.shape) == jcache[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(jcache[name].dtype)


@in_child
def test_hymba_decode_past_the_window_with_meta_tokens():
    """hymba (window 32, 8 meta tokens): a 40-token prompt is 48 positions
    with its meta tokens, so the prefill ring-aligns the last 32; then 28
    decode steps wrap the ring again.  Logits and every cache leaf against
    the reference, and the logits against the port's own forward."""
    import torch
    jlm, jp, tlm, tp = _pair("hymba_1_5b")
    meta, W = jlm.cfg.meta_tokens, jlm.cfg.swa_window
    S, extra = 40, 28
    toks = np.random.default_rng(9).integers(
        0, jlm.cfg.vocab, (1, S + extra)).astype(np.int32)
    full = tlm.forward(tp, toks)[:, meta:]
    cache = _serve_against_reference(jlm, jp, tlm, tp, toks, S, ATOL)
    assert cache["k"].shape[2] == W and cache["pos"] == meta + S + extra
    assert set(cache["positions"][0].tolist()) == set(
        range(meta + S + extra - W, meta + S + extra))
    lg, cache = tlm.prefill(tp, toks[:, :S])
    for t in range(extra):
        _close(lg, full[:, S - 1 + t].numpy(), ATOL)
        lg, cache = tlm.decode_step(
            tp, cache, torch.from_numpy(toks[:, S + t:S + t + 1]))


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "grok1_314b"])
@in_child
def test_bf16_families_against_reference(arch):
    """bf16 parameters carried bit for bit; forward, prefill and decode
    within the bf16 tolerance of the reference (grok uncapped)."""
    import torch
    replace = {"capacity_factor": 4.0} if arch == "grok1_314b" else {}
    jlm, jp, tlm, tp = _pair(arch, bf16=True, **replace)
    first = next(iter(tp["layers"].values()))
    assert first.dtype == torch.bfloat16
    toks = np.random.default_rng(10).integers(
        0, jlm.cfg.vocab, (2, 36)).astype(np.int32)
    full = tlm.forward(tp, toks)
    assert full.dtype == torch.bfloat16
    _close(full, jlm.forward(jp, toks), BF16_ATOL)
    cache = _serve_against_reference(jlm, jp, tlm, tp, toks, 32, BF16_ATOL)
    if arch == "mamba2_2_7b":
        assert cache["ssm_h"].dtype == torch.float32
        assert cache["conv"].dtype == torch.bfloat16


@in_child
def test_bf16_mamba2_full_width_rounds_as_the_reference():
    """mamba2_2_7b at full width, 2 layers, bf16 (``torch_drift.py``'s
    setup): the port's ``forward`` and decode logits within two bf16 steps
    of the reference's, and its decode-against-forward drift at most twice
    the reference's.  With ``F.silu`` (one rounding, where XLA's SiLU
    rounds each step of ``x * (1 / (1 + exp(-x)))``) the forward was 1.008
    away; the smoke width does not show it."""
    from torch_drift import drift_row
    r = drift_row("mamba2_2_7b", 2)
    assert r["forward_gap"] <= 0.0625, r
    assert r["decode_gap"] <= 0.0625, r
    assert r["port_drift"] <= 2 * r["ref_drift"], r


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "grok1_314b",
                                  "llama4_scout_17b_a16e", "hymba_1_5b",
                                  "mamba2_2_7b"])
@in_child
def test_new_trees_cross_with_params_from_arrays(arch):
    """The new families' trees (meta, enc_layers, SSM, MoE leaves) cross
    both ways with ``convert.py`` unchanged: float32 and bf16, bit for
    bit, in the reference's key order."""
    import torch
    from repro_torch.models.convert import params_from_arrays, \
        params_to_arrays
    for bf16 in (False, True):
        jlm = JLM(j_get_smoke_config(arch),
                  param_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        ref = _np_tree(jlm.init(jax.random.PRNGKey(1)))
        tree = params_from_arrays(ref, "cpu")
        back = params_to_arrays(tree)

        def walk(a, b, t):
            assert list(a) == list(b) == list(t)
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k], t[k])
                    continue
                assert t[k].dtype == (torch.bfloat16 if bf16
                                      else torch.float32)
                assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
                np.testing.assert_array_equal(
                    b[k].view(np.int16) if bf16 else b[k],
                    a[k].view(np.int16) if bf16 else a[k], err_msg=k)
        walk(ref, back, tree)

"""The port's LM (``repro_torch.models``, ``configs``, ``ServeEngine``)
against the JAX package's, on the CPU, for all ten architectures.

Mirrors ``tests/test_models_smoke.py``: smoke configs, the reference's
``LM.init`` parameters at float32 carried into the port with
``params_from_arrays``, and the same tokens (and, for the encoder-decoder,
the same frames) through both packages.  MoE configs run uncapped
(``capacity_factor = n_experts``) where a prefill is held to ``forward``, as
the reference's own serving test does: capacity routing couples tokens.
The new families' building blocks (SSD, MoE dispatch) are held in
``tests/test_torch_families.py``.

Tolerances, stated once:

  * float32, ``atol=2e-4``: the reference's own serving tolerance (forward
    against prefill and decode); both packages compute the same float32
    operations and differ only in the order of their sums;
  * the int8 KV cache: the cache is quantized from keys and values that
    agree to about 1e-6, so an int8 level may flip where a value sits on a
    rounding boundary; levels agree within 1 and scales within 1e-6, and
    logits within ``2e-3``, the change one flipped level can make;
  * bfloat16 parameters: every product and elementwise operation rounds to
    bf16 (8 bits of mantissa, a relative step of 2^-8) in an order each
    package chooses, so logits agree within ``0.05``, about a dozen such
    steps at a logit of magnitude 1.

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
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models.model import LM as JLM
from repro.runtime.serve import ServeEngine as JServeEngine

ATOL = 2e-4
INT8_ATOL = 2e-3
BF16_ATOL = 0.05


def _np_tree(tree):
    """A params tree as numpy arrays, in the tree's own key order."""
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _pair(arch, bf16=False, kv="bf16", **replace):
    """(reference LM, its params, port LM, the same params in torch)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.models.model import LM
    jcfg, tcfg = j_get_smoke_config(arch), get_smoke_config(arch)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        tcfg = dataclasses.replace(tcfg, **replace)
    jlm = JLM(jcfg, param_dtype=jnp.bfloat16 if bf16 else jnp.float32,
              kv_cache_dtype=kv)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tcfg, param_dtype=torch.bfloat16 if bf16 else torch.float32,
             kv_cache_dtype=kv)
    return jlm, jparams, tlm, params_from_arrays(_np_tree(jparams), "cpu")


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S)).astype(np.int32)


def _uncapped(arch):
    """The config change that makes an MoE prefill exact against forward."""
    n = j_get_smoke_config(arch).n_experts
    return {"capacity_factor": float(n)} if n else {}


def _frames(cfg, B, seed=0):
    """Stub frame embeddings (B, F, d) for an encoder-decoder, else None."""
    if not cfg.is_encdec:
        return None
    return np.random.default_rng(seed + 100).normal(
        size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _cache_equal(tcache, jcache, atol):
    """Every cache leaf: positions equal, the rest (keys and values, SSM
    states and conv tails, cross keys and values) within ``atol``."""
    assert tcache["pos"] == int(jcache["pos"])
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        if name == "positions":
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        elif name != "pos":
            assert tcache[name].shape == jcache[name].shape, name
            _close(tcache[name], jcache[name], atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_configs_match_reference(arch):
    from repro_torch.configs import get_config, get_smoke_config
    for t, j in ((get_config(arch), j_get_config(arch)),
                 (get_smoke_config(arch), j_get_smoke_config(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert t.padded_vocab == j.padded_vocab
    assert get_config(arch).n_params() > 1e8


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

@in_child
def test_layers_match_reference():
    import torch
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    sc = rng.normal(size=(32,)).astype(np.float32)
    tx, tsc = torch.from_numpy(x), torch.from_numpy(sc)
    _close(layers.rms_norm(tx, tsc), j_layers.rms_norm(x, sc), 1e-6)
    _close(layers.head_rms_norm(tx, tsc), j_layers.head_rms_norm(x, sc), 1e-6)
    pos = np.arange(7, dtype=np.int32) + 1000
    _close(layers.rope(tx, torch.from_numpy(pos), 1e6),
           j_layers.rope(x, pos, 1e6), 1e-5)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * .2
         for s in ((16, 24), (16, 24), (24, 16))]
    _close(layers.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w)),
           j_layers.swiglu(h, *w), 1e-5)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    labels[0, 1] = -100
    _close(layers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)),
           j_layers.cross_entropy(logits, labels), 1e-6)


@pytest.mark.parametrize("case", ["causal", "window", "cross", "positions",
                                  "banded"])
@in_child
def test_flash_attention_matches_reference(case):
    import torch
    from repro_torch.models import attention
    rng = np.random.default_rng(4)
    B, Sq, H, KV, D = 2, 37, 4, 2, 16
    Sk = 23 if case == "cross" else Sq
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    kw = dict(causal=case != "cross", block=8,
              window=5 if case in ("window", "banded") else 0,
              banded_window=case == "banded")
    tkw = dict(kw)
    if case == "positions":
        qp = np.arange(Sq, dtype=np.int32) + 40
        kp = np.arange(Sk, dtype=np.int32) + 40
        kw.update(q_positions=qp, kv_positions=kp)
        tkw.update(q_positions=torch.from_numpy(qp),
                   kv_positions=torch.from_numpy(kp))
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    _close(got, j_attn.flash_attention(q, k, v, **kw), 1e-5)
    if case == "banded":   # the band skips only fully masked blocks
        plain = attention.flash_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True, window=5,
            block=8)
        _close(got, plain.numpy(), 1e-5)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@in_child
def test_decode_attention_matches_reference(cache):
    import torch
    from repro_torch.models import attention
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 19, 8, 2, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kvpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kvpos[1, 12:] = -1
    qpos = np.array([15, 11], np.int32)
    if cache == "int8":
        kc = rng.integers(-127, 128, (B, S, KV, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (B, S, KV, D)).astype(np.int8)
        ks = (rng.random((B, S, KV, 1)) * .01).astype(np.float32)
        vs = (rng.random((B, S, KV, 1)) * .01).astype(np.float32)
    else:
        kc = rng.normal(size=(B, S, KV, D)).astype(np.float32)
        vc = rng.normal(size=(B, S, KV, D)).astype(np.float32)
        ks = vs = None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = attention.decode_attention(t(q), t(kc), t(vc), t(kvpos), t(qpos),
                                     k_scale=t(ks), v_scale=t(vs))
    want = j_attn.decode_attention(q, kc, vc, kvpos, qpos, k_scale=ks,
                                   v_scale=vs)
    # int8: both round q and the probabilities to bf16, in their own sums
    _close(got, want, 1e-5 if cache == "f32" else 1e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_forward_prefill_decode_match_reference(arch):
    """forward, the loss, prefill (logits and every cache leaf) and 3
    decode steps (logits and cache) within the reference's serving
    tolerance; hymba's forward carries its meta positions first."""
    import torch
    jlm, jp, tlm, tp = _pair(arch, **_uncapped(arch))
    B, S, extra = 2, 48, 3
    meta = jlm.cfg.meta_tokens
    toks = _tokens(jlm.cfg.vocab, B, S + extra)
    frames = _frames(jlm.cfg, B)
    full = tlm.forward(tp, toks, frames=frames)
    assert full.shape == (B, meta + S + extra, jlm.cfg.padded_vocab)
    _close(full, jlm.forward(jp, toks, frames=frames), ATOL)
    batch = {"tokens": toks, "frames": frames}
    _close(tlm.loss(tp, batch), jlm.loss(jp, batch), ATOL)
    full = full[:, meta:]
    lg, cache = tlm.prefill(tp, toks[:, :S], frames)
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :S], frames)
    _close(lg, jlg, ATOL)
    _close(lg, full[:, S - 1].numpy(), ATOL)
    _cache_equal(cache, jcache, ATOL)
    step = jax.jit(jlm.decode_step)
    for t in range(extra):
        nxt = toks[:, S + t:S + t + 1]
        lg, cache = tlm.decode_step(tp, cache, torch.from_numpy(nxt))
        jlg, jcache = step(jp, jcache, nxt)
        _close(lg, jlg, ATOL)
        _close(lg, full[:, S + t].numpy(), ATOL)
        _cache_equal(cache, jcache, ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_serve_engine_greedy_matches_reference(arch):
    """Greedy tokens of both packages' ``ServeEngine``; the encoder-decoder
    takes numpy frames, which the port's engine moves to its device."""
    from repro_torch.runtime.serve import ServeEngine
    jlm, jp, tlm, tp = _pair(arch, **_uncapped(arch))
    prompt = _tokens(jlm.cfg.vocab, 2, 24, seed=1)
    frames = _frames(jlm.cfg, 2, seed=1)
    jout, jst = JServeEngine(jlm, jp, cache_len=64).generate(
        prompt, 8, frames=frames)
    out, st = ServeEngine(tlm, tp, cache_len=64).generate(
        prompt, 8, frames=frames)
    np.testing.assert_array_equal(out, jout)
    assert out.dtype == jout.dtype
    assert st.tokens_generated == jst.tokens_generated == 16
    assert st.prefill_ms > 0 and st.decode_ms_per_token > 0


@in_child
def test_serve_engine_sampling_is_seeded():
    """Temperature sampling draws from a torch.Generator seeded with
    ``seed``: the same seed gives the same tokens, in the vocabulary."""
    from repro_torch.runtime.serve import ServeEngine
    _, _, tlm, tp = _pair("granite_3_2b")
    prompt = _tokens(tlm.cfg.vocab, 2, 16, seed=2)
    eng = ServeEngine(tlm, tp, cache_len=64)
    a, _ = eng.generate(prompt, 12, temperature=1.0, seed=7)
    b, _ = eng.generate(prompt, 12, temperature=1.0, seed=7)
    c, _ = eng.generate(prompt, 12, temperature=1.0, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tlm.cfg.vocab


@in_child
def test_swa_ring_cache_long_decode():
    """Sliding window 32: a decode far past the window, crossing the ring
    boundary repeatedly, stays within tolerance of the reference and of the
    port's own forward (the reference's test of the same name)."""
    import torch
    jlm, jp, tlm, tp = _pair("h2o_danube3_4b")
    B, S, extra = 1, 40, 24
    toks = _tokens(jlm.cfg.vocab, B, S + extra, seed=3)
    full = tlm.forward(tp, toks)
    lg, cache = tlm.prefill(tp, toks[:, :S])
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :S])
    _cache_equal(cache, jcache, ATOL)
    assert cache["k"].shape[2] == 32
    step = jax.jit(jlm.decode_step)
    for t in range(extra):
        nxt = toks[:, S + t:S + t + 1]
        lg, cache = tlm.decode_step(tp, cache, torch.from_numpy(nxt))
        jlg, jcache = step(jp, jcache, nxt)
        _close(lg, jlg, ATOL)
        _close(lg, full[:, S + t].numpy(), ATOL)
    _cache_equal(cache, jcache, ATOL)


@in_child
def test_int8_kv_cache_against_reference():
    """qwen15_32b's default int8 cache against the reference's int8 path."""
    import torch
    jlm, jp, tlm, tp = _pair("qwen15_32b", kv="int8")
    assert tlm.kv_cache_dtype == "int8"
    toks = _tokens(jlm.cfg.vocab, 2, 43, seed=4)
    lg, cache = tlm.prefill(tp, toks[:, :40])
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :40])
    step = jax.jit(jlm.decode_step)
    for t in range(4):
        _close(lg, jlg, INT8_ATOL)
        for name in ("k", "v"):
            assert cache[name].dtype == torch.int8
            diff = np.abs(cache[name].numpy().astype(np.int32)
                          - np.asarray(jcache[name]).astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
            _close(cache[name + "_scale"], jcache[name + "_scale"], 1e-6)
        if t == 3:
            break
        nxt = toks[:, 40 + t:41 + t]
        lg, cache = tlm.decode_step(tp, cache, torch.from_numpy(nxt))
        jlg, jcache = step(jp, jcache, nxt)
    # and close to the bf16-cache path, as the reference's own test holds it
    _, _, tlm16, _ = _pair("qwen15_32b", kv="bf16")
    lg16, _ = tlm16.prefill(tp, toks[:, :40])
    lg8, _ = tlm.prefill(tp, toks[:, :40])
    assert float((lg8 - lg16).abs().max()) < 0.15


@in_child
def test_banded_attention_matches_reference():
    """h2o_danube3_4b with ``banded_attention`` (the band-skipping prefill)
    against the reference and against the port's unbanded path."""
    import torch
    jlm, jp, tlm, tp = _pair("h2o_danube3_4b", banded_attention=True)
    _, _, plain, _ = _pair("h2o_danube3_4b")
    toks = _tokens(jlm.cfg.vocab, 2, 70, seed=5)
    full = tlm.forward(tp, toks)
    _close(full, jlm.forward(jp, toks), ATOL)
    _close(full, plain.forward(tp, toks).numpy(), ATOL)
    lg, cache = tlm.prefill(tp, toks[:, :66])
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :66])
    _close(lg, jlg, ATOL)
    _cache_equal(cache, jcache, ATOL)
    for t in range(4):
        lg, cache = tlm.decode_step(tp, cache,
                                    torch.from_numpy(toks[:, 66 + t:67 + t]))
        _close(lg, full[:, 66 + t].numpy(), ATOL)


@in_child
def test_bf16_serving_against_reference():
    """bf16 parameters carried bit for bit; forward, prefill and decode
    within the bf16 tolerance of the reference, and greedy tokens equal."""
    import torch
    from repro_torch.models.convert import params_to_arrays
    from repro_torch.runtime.serve import ServeEngine
    jlm, jp, tlm, tp = _pair("qwen3_4b", bf16=True)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    back = params_to_arrays(tp)
    for name in ("embed", "final_norm"):
        assert back[name].dtype == np.asarray(jp[name]).dtype
        np.testing.assert_array_equal(back[name].view(np.int16),
                                      np.asarray(jp[name]).view(np.int16))
    toks = _tokens(jlm.cfg.vocab, 2, 36, seed=6)
    full = tlm.forward(tp, toks)
    assert full.dtype == torch.bfloat16
    _close(full, jlm.forward(jp, toks), BF16_ATOL)
    lg, cache = tlm.prefill(tp, toks[:, :32])
    jlg, jcache = jax.jit(jlm.prefill)(jp, toks[:, :32])
    _close(lg, jlg, BF16_ATOL)
    step = jax.jit(jlm.decode_step)
    for t in range(4):
        nxt = toks[:, 32 + t:33 + t]
        lg, cache = tlm.decode_step(tp, cache, torch.from_numpy(nxt))
        jlg, jcache = step(jp, jcache, nxt)
        _close(lg, jlg, BF16_ATOL)


@in_child
def test_param_specs_and_key_order_match_reference():
    """``init`` records the reference's logical-axes tree and builds the
    reference's key order; ``params_from_arrays`` keeps it."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    for arch in ARCH_IDS:
        jlm, jp, _, tp = _pair(arch)
        assert list(tp) == list(jp)
        tlm = LM(get_smoke_config(arch), param_dtype=torch.float32)
        g = torch.Generator(device="cpu")
        g.manual_seed(0)
        own = tlm.init(g, device="cpu")
        assert list(own) == list(jp)
        for stack in ("layers", "enc_layers"):
            if stack not in jp:
                continue
            assert list(tp[stack]) == list(jp[stack])
            assert list(own[stack]) == list(jp[stack])
            for name, leaf in own[stack].items():
                assert tuple(leaf.shape) == jp[stack][name].shape, name
                assert leaf.dtype == torch.float32
        for name in ("embed", "meta", "final_norm", "enc_final_norm"):
            if name in jp:
                assert tuple(own[name].shape) == jp[name].shape
        assert tlm.param_specs() == jlm.param_specs(), arch


@in_child
def test_default_device_is_the_card():
    """With no card, the entry points' default device raises instead of
    running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs there")
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.convert import params_from_arrays
    _, jp, tlm, _ = _pair("granite_3_2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_arrays(_np_tree(jp))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_cache(1, 8)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CheckpointManager(root=d, codec="recoil")


@in_child
def test_decode_past_the_cache_raises():
    import torch
    _, _, tlm, tp = _pair("granite_3_2b")
    toks = _tokens(tlm.cfg.vocab, 1, 9)
    _, cache = tlm.prefill(tp, toks[:, :8], cache_len=8)
    with pytest.raises(ValueError, match="holds 8 positions"):
        tlm.decode_step(tp, cache, torch.from_numpy(toks[:, 8:9]))
    with pytest.raises(ValueError, match="cannot hold a prompt"):
        tlm.prefill(tp, toks, cache_len=8)

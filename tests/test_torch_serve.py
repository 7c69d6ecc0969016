"""The port's DecodeService on the CPU against the JAX package's
``DecodeService(impl="jnp")``.

Both services register the same contents (with and without an emission
log), serve them at several thread counts and through a fused
``submit``/``flush`` group that mixes layouts, and must return equal
symbols and equal plan, fusion and layout counters.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import recoil as j_recoil
from repro.core.rans import RansParams as JParams, StaticModel as JModel
from repro.core.vectorized import encode_interleaved_fast as j_encode
from repro.runtime.serve import DecodeService as JService

COUNTERS = ("compiles", "cache_hits", "decodes", "plan_hits", "plan_misses",
            "coalesced_requests", "fused_dispatches", "flushes",
            "symbol_plans", "pointer_plans")


def _setup(microbatch=16):
    from repro_torch.core import convert
    from repro_torch.runtime.serve import DecodeService
    rng = np.random.default_rng(99)
    payloads = {
        f"c{i}": np.minimum(
            rng.exponential(35.0, size=1_800 + 211 * i).astype(np.int64), 255)
        for i in range(3)}
    jm = JModel.from_symbols(np.concatenate(list(payloads.values())), 256,
                             JParams(n_bits=11, ways=32))
    tm = convert.model_from_arrays(jm.f, jm.F, 11, 32)
    jsvc = JService(jm, impl="jnp", microbatch=microbatch)
    tsvc = DecodeService(tm, device="cpu", microbatch=microbatch)
    for i, (name, syms) in enumerate(payloads.items()):
        enc = j_encode(syms, jm)
        jp = j_recoil.plan_splits(enc, 16)
        tp = convert.plan_from_arrays(**convert.plan_arrays(jp))
        log = enc.k_of_word if i < 2 else None     # c2 is pointer-only
        jsvc.register(name, jp, enc.stream, enc.final_states,
                      emission_log=log)
        tsvc.register(name, tp, enc.stream, enc.final_states,
                      emission_log=log, model=tm)
    return payloads, jsvc, tsvc


def _counters(svc):
    snap = svc.stats.snapshot()
    return {k: snap[k] for k in COUNTERS}


@in_child
def test_register_layouts_and_decode_match_reference():
    payloads, jsvc, tsvc = _setup()
    names = list(payloads)
    assert [tsvc.layout_for(n) for n in names] == \
        [jsvc.layout_for(n) for n in names] == ["symbol", "symbol", "pointer"]
    for name in names:
        for threads in (1, 3, 8, 16, 40):
            t_out = tsvc.decode(name, threads).numpy()
            np.testing.assert_array_equal(
                t_out, np.asarray(jsvc.decode(name, threads)))
            np.testing.assert_array_equal(t_out, payloads[name])
    # repeats hit the plan memo in both
    tsvc.decode(names[0], 8)
    jsvc.decode(names[0], 8)
    assert _counters(tsvc) == _counters(jsvc)
    assert tsvc.generation(names[0]) == 1
    assert tsvc.content(names[2]).stream.by_symbol is None


@pytest.mark.parametrize("microbatch", [8, 64])
@in_child
def test_fused_groups_match_reference(microbatch):
    """8 submits across contents: a symbol-only group stays on the symbol
    walk, a group with a pointer-only member downgrades as a unit; with
    ``microbatch=8`` the eighth submit flushes by itself."""
    payloads, jsvc, tsvc = _setup(microbatch)
    groups = [
        [("c0", 8), ("c1", 8), ("c0", 8), ("c1", 3), ("c0", 16), ("c1", 16),
         ("c0", 1), ("c1", 8)],
        [("c0", 8), ("c2", 8), ("c1", 4), ("c2", 16), ("c0", 2), ("c2", 1),
         ("c1", 8), ("c0", 8)],
    ]
    for reqs in groups:
        j_tickets = [jsvc.submit(n, th) for n, th in reqs]
        t_tickets = [tsvc.submit(n, th) for n, th in reqs]
        jsvc.flush()
        tsvc.flush()
        for (name, _), jt, tt in zip(reqs, j_tickets, t_tickets):
            t_out = tt.result().numpy()
            np.testing.assert_array_equal(t_out, np.asarray(jt.result()))
            np.testing.assert_array_equal(t_out, payloads[name])
        assert _counters(tsvc) == _counters(jsvc)
    stats = tsvc.stats
    assert stats.fused_dispatches == 2
    assert (stats.symbol_plans, stats.pointer_plans) == (1, 1)
    # a recurring group reuses its fused plan
    t_tickets = [tsvc.submit(n, th) for n, th in groups[0]]
    tsvc.flush()
    j_tickets = [jsvc.submit(n, th) for n, th in groups[0]]
    jsvc.flush()
    assert _counters(tsvc) == _counters(jsvc)
    assert tsvc.stats.symbol_plans == 1


@in_child
def test_register_validates_content():
    payloads, _, tsvc = _setup()
    c = tsvc.content("c0")
    with pytest.raises(ValueError, match="words"):
        tsvc.register("bad", c.plan, c.stream.host[:-1], c.final_states)
    with pytest.raises(ValueError, match="rANS invariant"):
        tsvc.register("bad", c.plan, c.stream.host,
                      np.zeros_like(c.final_states))

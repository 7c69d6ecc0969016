"""The port's DecodeService on the CPU against the JAX package's
``DecodeService(impl="jnp")``.

Both services register the same contents (with and without an emission
log), serve them at several thread counts, through a fused
``submit``/``flush`` group that mixes layouts and through the group backend
(``dispatch_group``/``prepare_group``), and must return equal symbols and
equal plan, fusion and layout counters.

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
from repro.runtime.serve import DecodeTicket as JTicket

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


@in_child
def test_fused_permutation_stays_int16():
    """A symbol-layout fused group concatenates the int16 permutations as
    they are (the reference upcasts to u32) and int16 streams beside them;
    it decodes equal to the reference, its plan is covered, and the
    counters stay equal."""
    import torch
    payloads, jsvc, tsvc = _setup()
    reqs = [("c0", 8), ("c1", 8), ("c0", 3), ("c1", 16)]
    j_tickets = [jsvc.submit(n, th) for n, th in reqs]
    t_tickets = [tsvc.submit(n, th) for n, th in reqs]
    jsvc.flush()
    tsvc.flush()
    for (name, _), jt, tt in zip(reqs, j_tickets, t_tickets):
        t_out = tt.result().numpy()
        np.testing.assert_array_equal(t_out, np.asarray(jt.result()))
        np.testing.assert_array_equal(t_out, payloads[name])
    (plan, _, _), = tsvc._fused_plans.values()
    assert plan.layout == "symbol" and plan.args[0].dtype == torch.int16
    assert plan.covered
    assert all(tsvc.content(n).stream.words.dtype == torch.int16
               for n in payloads)
    assert _counters(tsvc) == _counters(jsvc)


@in_child
def test_ingest_extend_and_batch_match_reference():
    """Content that enters as raw symbols: ``ingest`` serves on the symbol
    walk, ``extend`` re-registers (generation bump, plan memos dropped),
    ``ingest_batch`` registers several at once — outputs, plans and
    counters equal the reference service's."""
    from repro_torch.core import convert
    from repro_torch.runtime.serve import DecodeService
    rng = np.random.default_rng(5)
    syms = {name: np.minimum(rng.exponential(35.0, size=n).astype(np.int64),
                             255)
            for name, n in (("a", 9_001), ("b", 4_000), ("c", 5_555))}
    delta = np.minimum(rng.exponential(35.0, size=700).astype(np.int64), 255)
    jm = JModel.from_symbols(np.concatenate([*syms.values(), delta,
                                             np.arange(256)]), 256,
                             JParams(n_bits=11, ways=32))
    tm = convert.model_from_arrays(jm.f, jm.F, 11, 32)
    jsvc = JService(jm, impl="jnp")
    tsvc = DecodeService(tm, device="cpu")
    counters = COUNTERS + ("ingests", "extends")

    def same(name, threads, want):
        t_out = tsvc.decode(name, threads).numpy()
        np.testing.assert_array_equal(t_out, np.asarray(jsvc.decode(name,
                                                                    threads)))
        np.testing.assert_array_equal(t_out, want)

    def plans_equal(tp, jp):
        assert [p.offset for p in tp.points] == [p.offset for p in jp.points]
        for a, b in zip(tp.points, jp.points):
            np.testing.assert_array_equal(a.k, b.k)
            np.testing.assert_array_equal(a.y, b.y)

    plans_equal(tsvc.ingest("a", syms["a"], 16), jsvc.ingest("a", syms["a"],
                                                             16))
    assert tsvc.layout_for("a") == jsvc.layout_for("a") == "symbol"
    for threads in (4, 16, 4):
        same("a", threads, syms["a"])
    assert tsvc.can_extend("a") and not tsvc.can_extend("b")
    assert tsvc.generation("a") == jsvc.generation("a") == 1
    misses = tsvc.stats.plan_misses
    plans_equal(tsvc.extend("a", delta), jsvc.extend("a", delta))
    assert tsvc.generation("a") == jsvc.generation("a") == 2
    grown = np.concatenate([syms["a"], delta])
    same("a", 4, grown)
    assert tsvc.stats.plan_misses == misses + 1     # memo dropped
    t_plans = tsvc.ingest_batch({"b": syms["b"], "c": syms["c"]}, 8)
    j_plans = jsvc.ingest_batch({"b": syms["b"], "c": syms["c"]}, 8)
    for name in ("b", "c"):
        plans_equal(t_plans[name], j_plans[name])
        same(name, 3, syms[name])
    t_snap, j_snap = tsvc.stats.snapshot(), jsvc.stats.snapshot()
    assert {k: t_snap[k] for k in counters} == {k: j_snap[k] for k in counters}
    assert (t_snap["ingests"], t_snap["extends"]) == (3, 1)
    with pytest.raises(KeyError):
        tsvc.extend("zz", delta)
    with pytest.raises(ValueError, match="alphabet"):
        tsvc.ingest("bad", np.array([1, 2, 999]), 2)


@in_child
def test_dispatch_group_and_prepare_group_match_reference():
    """The group backend: ``dispatch_group`` fuses a mixed group into one
    launch with outputs and counters equal to the reference's, arrival
    order aside (a permutation of the group reuses its fused plan), and
    ``prepare_group`` builds the same plan without counting a dispatch."""
    from repro_torch.runtime.serve import DecodeTicket
    payloads, jsvc, tsvc = _setup()
    reqs = [("c0", 8), ("c2", 16), ("c1", 4), ("c0", 3), ("c2", 1)]
    for group in (reqs, reqs[::-1]):
        t_tickets = [DecodeTicket(tsvc) for _ in group]
        j_tickets = [JTicket(jsvc) for _ in group]
        tsvc.dispatch_group(group, t_tickets)
        jsvc.dispatch_group(group, j_tickets)
        for (name, _), tt, jt in zip(group, t_tickets, j_tickets):
            t_out = tt.result().numpy()
            np.testing.assert_array_equal(t_out, np.asarray(jt.result()))
            np.testing.assert_array_equal(t_out, payloads[name])
        assert _counters(tsvc) == _counters(jsvc)
    assert tsvc.stats.fused_dispatches == 2 and len(tsvc._fused_plans) == 1
    before = _counters(tsvc)
    plan = tsvc.prepare_group(reqs)
    jplan = jsvc.prepare_group(reqs)
    assert _counters(tsvc)["fused_dispatches"] == before["fused_dispatches"]
    assert _counters(tsvc) == _counters(jsvc)
    (fused, _, _), = tsvc._fused_plans.values()
    assert plan is fused and plan.n_symbols == jplan.n_symbols
    assert tsvc.session.is_compiled(plan)
    single = tsvc.prepare_group([("c1", 4)])
    assert single is tsvc.prepare_request("c1", 4)
    jsvc.prepare_group([("c1", 4)])
    jsvc.prepare_request("c1", 4)
    assert _counters(tsvc) == _counters(jsvc)


@in_child
def test_content_snapshot_and_evict_prepared():
    """``content_snapshot`` pairs the generation with its content;
    ``evict_prepared`` drops one pair's memos (and says so like the
    reference), and the next request re-derives bit-exactly."""
    payloads, jsvc, tsvc = _setup()
    gen, content = tsvc.content_snapshot("c1")
    assert gen == jsvc.content_snapshot("c1")[0] == 1
    assert content is tsvc.content("c1")
    with pytest.raises(KeyError):
        tsvc.content_snapshot("missing")
    c = tsvc.content("c1")
    tsvc.register("c1", c.plan, c.stream.host, c.final_states)
    jc = jsvc.content("c1")
    jsvc.register("c1", jc.plan, jc.stream.host, jc.final_states)
    assert tsvc.content_snapshot("c1")[0] == \
        jsvc.content_snapshot("c1")[0] == 2
    for svc in (tsvc, jsvc):
        svc.decode("c1", 8)
        svc.decode("c1", 8)
    assert tsvc.evict_prepared("c1", 8) is jsvc.evict_prepared("c1", 8) \
        is True
    assert tsvc.evict_prepared("c1", 8) is jsvc.evict_prepared("c1", 8) \
        is False
    misses = tsvc.stats.plan_misses
    t_out = tsvc.decode("c1", 8).numpy()
    np.testing.assert_array_equal(t_out, np.asarray(jsvc.decode("c1", 8)))
    np.testing.assert_array_equal(t_out, payloads["c1"])
    assert tsvc.stats.plan_misses == misses + 1   # re-derived, not a hit
    assert _counters(tsvc) == _counters(jsvc)

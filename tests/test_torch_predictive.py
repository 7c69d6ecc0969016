"""The port's predictive hot-set serving on the CPU: heat tracker,
speculative pre-thinning, deadline-aware dispatch, admission control and the
generation race, held against the reference.

The reference's ``tests/test_predictive.py``, all of it, ported to the
port's service (``device="cpu"``).  "Compile-free" reads as the port means
it: no launcher resolved (``svc.stats.compiles`` counts plan-key misses).
The decay math is also driven beside the reference's with the same
injected clock: ``DecayingCounter`` values and ``HeatTracker`` heats, hot
sets and snapshots are equal, field by field.

Every ``result``/``drain`` here has a timeout of at most 30 s.  Each test
runs in a child pytest process (``test_torch_isolation.in_child``), and the
port is imported inside the tests, so the test worker itself never loads
torch beside jaxlib.
"""

import threading
import time

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.runtime.metrics import DecayingCounter as JCounter
from repro.runtime.pipeline import HeatTracker as JTracker

T = 30.0    # every wait in this file is bounded


def _payloads(n_contents=3, size=2048, seed=3):
    rng = np.random.default_rng(seed)
    return {f"c{i}": np.minimum(
        rng.exponential(35.0, size=size).astype(np.int64), 255)
        for i in range(n_contents)}


def _model(payloads):
    from repro_torch.core.rans import RansParams, StaticModel
    return StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256,
        RansParams(n_bits=11, ways=32))


def _service(payloads, n_splits=16, **kw):
    from repro_torch.runtime.serve import DecodeService
    svc = DecodeService(_model(payloads), device="cpu", **kw)
    svc.ingest_batch(payloads, n_splits)
    return svc


def _extendable_service(payloads, n_splits=16):
    """Per-name ``ingest`` (not ``ingest_batch``) so the encoder records
    resumable tails and ``extend`` works."""
    from repro_torch.runtime.serve import DecodeService
    svc = DecodeService(_model(payloads), device="cpu")
    for name, syms in payloads.items():
        svc.ingest(name, syms, n_splits)
    return svc


# ----------------------------------------------------------------------
# Decay math (pure, synthetic clocks)
# ----------------------------------------------------------------------

@in_child
def test_decaying_counter_half_life():
    from repro_torch.runtime.metrics import DecayingCounter
    c = DecayingCounter(half_life_s=10.0)
    assert c.value(now=0.0) == 0.0
    c.observe(1.0, now=0.0)
    assert abs(c.value(now=10.0) - 0.5) < 1e-9      # one half-life
    assert abs(c.value(now=20.0) - 0.25) < 1e-9
    c.observe(1.0, now=10.0)                        # decayed 0.5 + 1
    assert abs(c.value(now=10.0) - 1.5) < 1e-9
    with pytest.raises(ValueError):
        DecayingCounter(half_life_s=0.0)


@in_child
def test_heat_tracker_orders_and_decays():
    from repro_torch.runtime.pipeline import HeatTracker
    t = [0.0]
    trk = HeatTracker(half_life_s=10.0, clock=lambda: t[0])
    for _ in range(8):
        trk.observe("a", 8)
    trk.observe("b", 8)
    trk.observe("b", 64)
    assert trk.hot_set() == [("a", 8), ("b", 8), ("b", 64)]
    assert trk.hot_set(limit=1) == [("a", 8)]
    assert trk.hot_set(min_heat=2.0) == [("a", 8)]
    # 100 half-lives later "a"'s burst has faded below a fresh observation
    t[0] = 1000.0
    trk.observe("b", 8)
    assert trk.hot_set(min_heat=0.5) == [("b", 8)]
    trk.forget("b")
    assert trk.heat("b", 8) == 0.0
    snap = trk.snapshot()
    assert snap["pairs"] == 1 and snap["observations"] == 11


@pytest.mark.parametrize("half_life", [0.5, 10.0, 1e9])
@in_child
def test_decay_math_equals_reference(half_life):
    """The same seeded observation sequence, on one injected clock, through
    the reference's ``DecayingCounter``/``HeatTracker`` and the port's
    copies: every returned heat, every value read, every hot set and the
    final snapshot are equal."""
    from repro_torch.runtime.metrics import DecayingCounter
    from repro_torch.runtime.pipeline import HeatTracker
    now = [0.0]
    jt = JTracker(half_life_s=half_life, clock=lambda: now[0])
    tt = HeatTracker(half_life_s=half_life, clock=lambda: now[0])
    jc, tc = JCounter(half_life), DecayingCounter(half_life)
    rng = np.random.default_rng(int(half_life * 10) % 97)
    names = ("a", "b", "c", "d")
    for step in range(300):
        now[0] += float(rng.exponential(0.3))
        name, cap = names[rng.integers(4)], int((2, 8, 64)[rng.integers(3)])
        w = float(rng.uniform(0.1, 5.0))
        assert tt.observe(name, cap, w) == jt.observe(name, cap, w)
        assert tc.observe(w, now[0]) == jc.observe(w, now[0])
        assert tc.value(now[0] + 1.0) == jc.value(now[0] + 1.0)
        assert tt.heat(name, cap) == jt.heat(name, cap)
        lim = int(rng.integers(1, 6))
        mh = float(rng.uniform(0.0, 3.0))
        assert tt.hot_set(limit=lim, min_heat=mh) == \
            jt.hot_set(limit=lim, min_heat=mh)
        if step % 50 == 49:
            tt.forget(name)
            jt.forget(name)
        assert tt.snapshot() == jt.snapshot()


# ----------------------------------------------------------------------
# Controller deadline classes (pure)
# ----------------------------------------------------------------------

@in_child
def test_controller_deadline_class_budgets():
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    ctl = AdaptiveController(ControllerConfig(target_delay_ms=40.0))
    assert ctl.budget_ms(None) == ("standard", 40.0)
    assert ctl.budget_ms("interactive") == ("interactive", 10.0)
    assert ctl.budget_ms("bulk") == ("bulk", 320.0)
    assert ctl.budget_ms(75.0) == ("custom", 75.0)
    with pytest.raises(KeyError):
        ctl.budget_ms("premium")
    with pytest.raises(ValueError):
        ctl.budget_ms(-1.0)
    named = AdaptiveController(ControllerConfig(
        deadline_classes=(("gold", 5.0), ("best_effort", 1000.0))))
    assert named.budget_ms("gold") == ("gold", 5.0)
    with pytest.raises(KeyError):
        named.budget_ms("standard")


@in_child
def test_controller_decide_flush_slack():
    from repro_torch.runtime.pipeline import (AdaptiveController,
                                              ControllerConfig)
    ctl = AdaptiveController(ControllerConfig(
        max_batch=8, target_delay_ms=3_600_000.0))
    # fast arrivals -> the fixpoint target exceeds the queued count, so
    # only the deadline path can flush this partial lane
    for i in range(32):
        ctl.observe_arrival(8, i * 1e-3)
    now = 32e-3
    assert ctl.target_batch(8, now) > 2
    # slack remaining: keep accumulating, re-check when it runs out
    d = ctl.decide(8, queued=2, oldest_wait_ms=1.0, now=now,
                   flush_slack_ms=12.5)
    assert not d.dispatch and d.wait_more_ms == 12.5
    # slack exhausted: partial flush NOW, despite the frozen flat floor
    d = ctl.decide(8, queued=2, oldest_wait_ms=1.0, now=now,
                   flush_slack_ms=0.0)
    assert d.dispatch and d.batch == 2
    # no-deadline callers keep the legacy oldest-wait floor
    d = ctl.decide(8, queued=2, oldest_wait_ms=1.0, now=now)
    assert not d.dispatch
    assert "deadline_classes" in ctl.snapshot()


# ----------------------------------------------------------------------
# Broker: deadline-aware flush + admission control
# ----------------------------------------------------------------------

def _frozen_cfg(**kw):
    """A controller config whose flat floor and standard class never fire
    within a test's lifetime — only explicit deadlines can flush."""
    from repro_torch.runtime.pipeline import ControllerConfig
    base = dict(max_batch=64, batch_sizes=(64,),
                target_delay_ms=3_600_000.0,
                deadline_classes=(("interactive", 60.0),
                                  ("standard", 3_600_000.0),
                                  ("bulk", 7_200_000.0)))
    base.update(kw)
    return ControllerConfig(**base)


@in_child
def test_broker_deadline_flushes_partial_lane():
    payloads = _payloads()
    svc = _service(payloads)
    with svc.start_pipeline(config=_frozen_cfg(), predictive=False):
        # A bulk ticket alone leaves the lane accumulating...
        bulk = svc.submit("c0", 8, deadline="bulk")
        time.sleep(0.3)
        assert not bulk.done()
        # ...but an interactive ticket's budget flushes the WHOLE lane
        # (min slack over queued tickets, not just the head's).
        inter = svc.submit("c1", 8, deadline="interactive")
        np.testing.assert_array_equal(
            inter.result(timeout=T).numpy(), payloads["c1"])
        np.testing.assert_array_equal(
            bulk.result(timeout=T).numpy(), payloads["c0"])
        assert inter.deadline_class == "interactive"
        assert bulk.deadline_at > inter.deadline_at
    svc.stop_pipeline()


@in_child
def test_broker_per_lane_admission_retry_after():
    from repro_torch.runtime.pipeline import BrokerSaturated
    svc = _service(_payloads())
    with svc.start_pipeline(config=_frozen_cfg(), max_lane_depth=2,
                            predictive=False) as broker:
        t1 = svc.submit("c0", 8, deadline="bulk")
        t2 = svc.submit("c1", 8, deadline="bulk")
        with pytest.raises(BrokerSaturated) as exc:
            svc.submit("c2", 8, deadline="bulk")
        assert exc.value.retry_after_s is not None
        assert exc.value.retry_after_s > 0.0
        # the bound is per lane: a different capability still admits
        t3 = svc.submit("c2", 4, deadline="bulk")
        snap = broker.snapshot()
        assert snap["admission"]["max_lane_depth"] == 2
        assert snap["admission"]["lane_depths"][8] == 2
        assert snap["admission"]["retry_after_s"][8] > 0.0
        assert snap["rejected"] == 1
        for t in (t1, t2, t3):
            t.cancel()
    svc.stop_pipeline()


# ----------------------------------------------------------------------
# Speculative pre-thinning
# ----------------------------------------------------------------------

@in_child
def test_speculate_covers_hot_set_first_request_compile_free():
    from repro_torch.runtime.pipeline import ControllerConfig
    payloads = _payloads()
    svc = _service(payloads)
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=2, batch_sizes=(1, 2),
                                    target_delay_ms=5.0)) as broker:
        broker.anticipate("c0", 8, weight=4.0)
        broker.anticipate("c1", 8, weight=2.0)
        assert broker.speculate() > 0
        assert broker.speculate() == 0          # idempotent: fully covered
        pre = broker.prethinner.snapshot()
        assert pre["covered_pairs"] == 2
        assert pre["prethins"] == 2
        assert pre["warm_compiles"] > 0
        compiles0 = svc.stats.compiles
        # first REAL requests: served from speculative derivations,
        # resolved launchers only
        out = svc.submit("c0", 8).result(timeout=T)
        np.testing.assert_array_equal(out.numpy(), payloads["c0"])
        wire = broker.registry.container_for_threads("c0", 8)
        assert isinstance(wire, bytes) and len(wire) > 0
        assert svc.stats.compiles == compiles0
        assert broker.registry.snapshot()["speculative_hits"] > 0
    svc.stop_pipeline()


@in_child
def test_idle_gap_speculation_runs_on_ingest_worker():
    from repro_torch.runtime.pipeline import ControllerConfig
    svc = _service(_payloads())
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=2, batch_sizes=(1, 2),
                                    target_delay_ms=5.0)) as broker:
        broker.anticipate("c0", 8, weight=4.0)
        deadline = time.perf_counter() + T
        while time.perf_counter() < deadline:
            if broker.prethinner.snapshot()["covered_pairs"] >= 1 \
                    and not broker.prethinner.pending():
                break
            time.sleep(0.02)
        pre = broker.prethinner.snapshot()
        assert pre["covered_pairs"] >= 1       # worker ran it in idle gaps
        assert pre["prethins"] >= 1
        assert broker.snapshot()["heat"]["pairs"] == 1
    svc.stop_pipeline()


@in_child
def test_prethinner_reruns_after_generation_bump():
    from repro_torch.runtime.pipeline import ControllerConfig
    payloads = _payloads()
    svc = _extendable_service(payloads)
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=1, batch_sizes=(1,),
                                    target_delay_ms=5.0),
            predictive=True) as broker:
        broker.anticipate("c0", 8, weight=4.0)
        broker.speculate()
        pre1 = broker.prethinner.snapshot()["prethins"]
        delta = np.arange(64, dtype=np.int64) % 251
        svc.extend("c0", delta)                # generation bump
        assert broker.speculate() > 0          # pair is due again
        assert broker.prethinner.snapshot()["prethins"] == pre1 + 1
        out = svc.submit("c0", 8).result(timeout=T)
        np.testing.assert_array_equal(
            out.numpy(), np.concatenate([payloads["c0"], delta]))
    svc.stop_pipeline()


@in_child
def test_prepare_group_probe_and_is_compiled():
    svc = _service(_payloads())
    reqs = [("c0", 8), ("c1", 8)]
    plan = svc.prepare_group(reqs)
    assert not svc.session.is_compiled(plan)
    svc.session.execute(plan)
    assert svc.session.is_compiled(plan)
    n0 = svc.session.executables
    assert svc.prepare_group(reqs) is not None  # memo hit, no new launcher
    assert svc.session.executables == n0
    with pytest.raises(KeyError):
        svc.prepare_group([("nope", 8)])


# ----------------------------------------------------------------------
# Cache-bound behavior (entry budgets, popularity eviction)
# ----------------------------------------------------------------------

@in_child
def test_registry_budget_evicts_cold_pairs_first():
    from repro_torch.core.recoil import combine_plan
    from repro_torch.runtime.pipeline import CapabilityRegistry, HeatTracker
    payloads = _payloads()
    svc = _service(payloads)
    t = [0.0]
    trk = HeatTracker(half_life_s=1e9, clock=lambda: t[0])
    reg = CapabilityRegistry(svc, max_entries=2, tracker=trk)
    trk.observe("c0", 8, weight=10.0)
    trk.observe("c1", 8, weight=5.0)
    trk.observe("c2", 8, weight=1.0)
    p0 = reg.plan_for_threads("c0", 8)
    p1 = reg.plan_for_threads("c1", 8)
    # a cold insert is returned to its caller but never displaces a
    # hotter resident
    p2 = reg.plan_for_threads("c2", 8)
    snap = reg.snapshot()
    assert snap["plans_cached"] == 2 and snap["evictions"] == 1
    assert ("c2", 8) not in reg._plan_memo
    assert ("c0", 8) in reg._plan_memo and ("c1", 8) in reg._plan_memo
    # the pair re-heats -> re-derivation displaces the now-coldest (c1),
    # and every derivation is bit-exact vs a direct thinning
    trk.observe("c2", 8, weight=50.0)
    p2b = reg.plan_for_threads("c2", 8)
    assert ("c2", 8) in reg._plan_memo and ("c1", 8) not in reg._plan_memo
    for name, plan in (("c0", p0), ("c1", p1), ("c2", p2), ("c2", p2b)):
        want = combine_plan(svc.content(name).plan, 8)
        assert plan.n_symbols == want.n_symbols
        assert [pt.offset for pt in plan.points] == \
            [pt.offset for pt in want.points]
    # hot pair still decodes bit-exact after all the churn
    np.testing.assert_array_equal(svc.decode("c2", 8).numpy(),
                                  payloads["c2"])


@in_child
def test_prethinner_capacity_evicts_and_rederives_bit_exact():
    from repro_torch.runtime.pipeline import ControllerConfig
    payloads = _payloads()
    svc = _service(payloads)
    with svc.start_pipeline(
            config=ControllerConfig(max_batch=1, batch_sizes=(1,),
                                    target_delay_ms=5.0),
            speculative_capacity=2, min_heat=0.1) as broker:
        broker.anticipate("c0", 8, weight=10.0)
        broker.anticipate("c1", 8, weight=5.0)
        # a pair colder than every would-be resident is not even derived
        # (deriving it would churn: eviction would throw it right back out)
        broker.anticipate("c2", 8, weight=1.0)
        broker.speculate()
        pre = broker.prethinner.snapshot()
        assert pre["covered_pairs"] == 2
        assert pre["evictions"] == 0
        # the cold pair re-heats past a resident -> it IS derived and the
        # now-coldest resident (c1) is evicted to make room
        broker.anticipate("c2", 8, weight=50.0)
        assert broker.speculate() > 0
        pre = broker.prethinner.snapshot()
        assert pre["covered_pairs"] == 2
        assert pre["evictions"] == 1
        # both the evicted pair and a covered one decode bit-exact
        out = svc.submit("c1", 8).result(timeout=T)
        np.testing.assert_array_equal(out.numpy(), payloads["c1"])
        out = svc.submit("c2", 8).result(timeout=T)
        np.testing.assert_array_equal(out.numpy(), payloads["c2"])
    svc.stop_pipeline()


# ----------------------------------------------------------------------
# Generation race regression (threaded)
# ----------------------------------------------------------------------

@in_child
def test_registry_generation_never_tears_under_extend_storm():
    """A concurrent ``extend`` re-registration must never let the registry
    tag a memo entry with a generation that does not match the bytes it
    was derived from.  Every extend grows the asset by a fixed delta, so
    ``n_symbols`` is a fingerprint of the generation: a torn (gen, plan)
    pair is directly observable (``content_snapshot`` reads both under one
    service-lock hold)."""
    from repro_torch.runtime.pipeline import CapabilityRegistry
    payloads = _payloads(n_contents=1, size=1024)
    svc = _extendable_service(payloads, n_splits=8)
    reg = CapabilityRegistry(svc)
    base = payloads["c0"].size
    dlen = 32
    delta = (np.arange(dlen, dtype=np.int64) % 251)
    n_extends = 30
    stop = threading.Event()
    errors = []

    def extender():
        try:
            for _ in range(n_extends):
                svc.extend("c0", delta)
        except Exception as e:              # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                for cap in (2, 8):
                    plan = reg.plan_for_threads("c0", cap)
                    # derived length must BE a generation's length
                    assert (plan.n_symbols - base) % dlen == 0
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=extender)] + \
        [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    # every surviving memo entry's tagged generation implies exactly its
    # derived length (gen 1 = base, each bump adds dlen)
    with reg._lock:
        entries = list(reg._plan_memo.items())
    assert entries
    for (name, cap), (gen, plan, _spec) in entries:
        assert plan.n_symbols == base + (gen - 1) * dlen, (
            f"memo for ({name},{cap}) tagged gen {gen} but derived "
            f"{plan.n_symbols} symbols")
    # and the final state decodes bit-exact
    want = np.concatenate([payloads["c0"]] + [delta] * n_extends)
    np.testing.assert_array_equal(svc.decode("c0", 8).numpy(), want)

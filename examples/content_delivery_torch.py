"""The paper's content-delivery scenario end-to-end (§3.3, §5) on the
PyTorch/CUDA port: ``examples/content_delivery.py`` through
``repro_torch``, at the same sizes and seeds, with the same checks.

A server encodes content ONCE at max parallelism (2176 splits, GPU-grade).
Clients attach their parallel capacity to the request; the server thins the
split metadata in real time (no re-encode, no second stored variant) and
ships bitstream + right-sized metadata.  Every client decodes with its own
thread count and verifies the content.

Clients decode through a persistent
:class:`repro_torch.core.engine.DecoderSession` — slot tables resident on
the device and a bucketed launcher cache — so only a client's FIRST fetch
resolves a launcher (the reference's ``compiles`` counter); repeat fetches
(even of different-sized payloads within a shape bucket) reuse it.

    PYTHONPATH=src python examples/content_delivery_torch.py    # on the card

``main(device="cpu")`` runs the same calls on the plain torch walks and
the plain versions of the ingest kernels.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import container, recoil
from repro_torch.core.engine import DecoderSession
from repro_torch.core.rans import RansParams, StaticModel

# The two largest demos' sizes (symbols), the reference example's; a test
# on the CPU sets smaller ones.
PAYLOAD_SIZE = 4_000_000
CAPABILITY_SIZE = 500_000


class ContentServer:
    """Encode once; serve any client parallelism by deleting metadata.

    Encoding runs through the ingest engine (``core.encode.EncoderSession``
    on the device); this wire-format server brings the stream to the host
    for ``container`` packing, while the pure-serving path
    (``DecodeService.ingest``, see ``microbatch_demo``) keeps it on the
    device end to end."""

    def __init__(self, payload: np.ndarray, device, max_splits: int = 2176):
        from repro_torch.core.encode import EncoderSession
        self.params = RansParams(n_bits=11, ways=32)
        self.model = StaticModel.from_symbols(payload, 256, self.params)
        self.encoder = EncoderSession(self.model, device=device)
        t0 = time.perf_counter()
        self.enc = self.encoder.encode(payload)
        self.plan = recoil.plan_splits(self.enc, max_splits)
        self.encode_s = time.perf_counter() - t0

    def serve(self, client_threads: int) -> bytes:
        t0 = time.perf_counter()
        plan = recoil.combine_plan(self.plan, client_threads)
        buf = container.pack_recoil(self.enc, self.model, plan)
        self.last_serve_ms = (time.perf_counter() - t0) * 1e3
        return buf


class Client:
    """Holds a decode session across fetches — slot tables and resolved
    launchers persist, so steady-state fetches resolve nothing."""

    def __init__(self, name: str, threads: int, device):
        self.name, self.threads, self.device = name, threads, device
        self.session = None

    def fetch_and_decode(self, server: ContentServer) -> np.ndarray:
        buf = server.serve(self.threads)
        self.received_bytes = len(buf)
        pc = container.parse(buf, server.params)
        if self.session is None:
            self.session = DecoderSession(pc.model, device=self.device)
        t0 = time.perf_counter()
        out = self.session.decode(pc.plan, pc.stream, pc.final_states)
        out = out.cpu().numpy()  # sync for honest timing
        self.decode_s = time.perf_counter() - t0
        return out


def main(device="cuda"):
    rng = np.random.default_rng(7)
    payload = np.minimum(
        rng.exponential(35, size=PAYLOAD_SIZE).astype(np.int64), 255)
    server = ContentServer(payload, device)
    print(f"server: encoded {len(payload)/1e6:.0f} MB once in "
          f"{server.encode_s:.2f}s at {server.plan.n_threads} splits\n")
    clients = [Client("phone (2 cores)", 2, device),
               Client("laptop (16 cores)", 16, device),
               Client("workstation (256)", 256, device),
               Client("gpu-box (2176)", 2176, device)]
    for c in clients:
        out = c.fetch_and_decode(server)
        assert (out == payload).all(), f"{c.name}: decode mismatch!"
        print(f"{c.name:20s} fetched {c.received_bytes:>9,} B "
              f"(server thinning {server.last_serve_ms:6.1f} ms)  "
              f"decoded+verified in {c.decode_s:5.2f}s with "
              f"{c.threads} threads")
    big = clients[-1].received_bytes
    small = clients[0].received_bytes
    print(f"\nbandwidth saved for the phone vs shipping the GPU variation: "
          f"{big - small:,} B ({100 * (big - small) / big:.2f}%) — "
          f"the paper's decoder-adaptive scalability claim")

    # Steady state: the same clients fetch again — sessions are warm, the
    # second decode reuses the resolved launcher (0 new compiles).
    print("\nsecond fetch (warm sessions):")
    for c in clients:
        before = c.session.stats.compiles
        out = c.fetch_and_decode(server)
        assert (out == payload).all()
        print(f"{c.name:20s} decoded in {c.decode_s:5.2f}s  "
              f"(new compiles: {c.session.stats.compiles - before}, "
              f"cache hits: {c.session.stats.cache_hits})")

    microbatch_demo(device)


def microbatch_demo(device):
    """Server-side decode: assets arrive as raw symbols and are ingested by
    the encode engine (``DecodeService.ingest`` — encode + Def-4.1 split
    planning on the device, stream never visits the host), then many small
    concurrent requests coalesce into one fused launch
    (runtime.serve.DecodeService.submit/flush)."""
    from repro_torch.runtime.serve import DecodeService

    rng = np.random.default_rng(11)
    params = RansParams(n_bits=11, ways=32)
    payloads = {f"asset{i}": np.minimum(
        rng.exponential(35, size=2_000).astype(np.int64), 255)
        for i in range(8)}
    model = StaticModel.from_symbols(
        np.concatenate(list(payloads.values())), 256, params)
    svc = DecodeService(model, device=device, microbatch=8)
    t0 = time.perf_counter()
    svc.ingest_batch(payloads, 16)   # ONE batched encode+plan pipeline call
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()         # refreshed assets: nothing to resolve
    svc.ingest_batch(payloads, 16)
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"\ningested {len(payloads)} assets: {cold_ms:.0f} ms cold "
          f"(the encoder resolves no launcher per shape), "
          f"{warm_ms:.1f} ms warm re-ingest")
    print("microbatched decode (8 concurrent small asset requests):")
    # warm: the first round resolves the fused bucket's launcher
    tickets = {n: svc.submit(n, 16) for n in payloads}
    svc.flush()
    for name, t in tickets.items():
        assert (t.result().cpu().numpy() == payloads[name]).all()
    # steady state: one fused launch for all 8 requests
    t0 = time.perf_counter()
    tickets = {n: svc.submit(n, 16) for n in payloads}
    svc.flush()
    for name, t in tickets.items():
        assert (t.result().cpu().numpy() == payloads[name]).all()
    dt = (time.perf_counter() - t0) * 1e3
    s = svc.stats
    print(f"8 requests decoded+verified in {dt:.1f} ms via "
          f"{s.fused_dispatches} fused dispatches "
          f"({s.coalesced_requests} requests coalesced, "
          f"plan cache hits: {s.plan_hits})")

    capability_demo(device)


def capability_demo(device):
    """Capability negotiation through the async pipeline: clients DECLARE
    their parallelism once (``CapabilityRegistry``); the server ships each
    one the same bitstream with metadata thinned to its declaration — the
    transfer-size vs decode-parallelism tradeoff of the paper's §3.3,
    served per client instead of per call.  Decode requests ride the
    broker's capability lanes (uniform-capability fused groups, adaptive
    flush, ingest overlapped on its own worker)."""
    from repro_torch.core.recoil import decode_recoil
    from repro_torch.runtime.serve import DecodeService

    rng = np.random.default_rng(23)
    params = RansParams(n_bits=11, ways=32)
    asset = np.minimum(
        rng.exponential(35, size=CAPABILITY_SIZE).astype(np.int64), 255)
    model = StaticModel.from_symbols(asset, 256, params)
    svc = DecodeService(model, device=device)
    svc.ingest("asset", asset, 128)   # planned once at server parallelism
    print("\ncapability negotiation (same asset, three declared clients):")
    with svc.start_pipeline() as broker:
        reg = broker.registry
        clients = [("iot-sensor", 1), ("phone", 8), ("edge-box", 64)]
        for cid, threads in clients:
            reg.declare(cid, threads)
        full = svc.decode("asset", 128).cpu().numpy()
        base = None
        for cid, threads in clients:
            buf = reg.container_for("asset", cid)   # thinned wire payload
            t0 = time.perf_counter()
            out = reg.submit_for("asset", cid).result().cpu().numpy()
            dt = (time.perf_counter() - t0) * 1e3
            assert (out == full).all() and (out == asset).all()
            pc = container.parse(buf, params)
            assert (decode_recoil(pc.plan, pc.stream, pc.final_states,
                                  pc.model) == asset).all()
            base = base or len(buf)
            print(f"  {cid:11s} declares {threads:3d} threads -> "
                  f"{len(buf):>9,} B on wire "
                  f"(+{len(buf) - base:>6,} B metadata vs 1-thread), "
                  f"decoded+verified in {dt:6.1f} ms")
        snap = broker.snapshot()
        print(f"  broker: {snap['completed']} requests, "
              f"wait p50 {snap['wait']['p50_ms']:.1f} ms, "
              f"overlap ratio {snap['overlap']['overlap_ratio']:.2f}")

    predictive_demo(device)


def predictive_demo(device):
    """Predictive hot-set serving: a skewed client population hammers a few
    (content, capability) pairs; the broker's heat tracker ranks them and
    its pre-thinner derives thinned plans, downscaled containers and
    resolved launch shapes in idle gaps — so the hot set's FIRST real fetch
    is served entirely from caches.  Compare the same cold first fetches on
    a reactive broker."""
    from repro_torch.runtime.serve import DecodeService

    rng = np.random.default_rng(31)
    params = RansParams(n_bits=11, ways=32)
    # Distinct sizes -> distinct shape buckets: every pair's cold first
    # request resolves a launcher on the reactive path.
    sizes = {"news": 8_000, "map-tile": 18_000, "video-seg": 42_000}
    caps = {"news": 8, "map-tile": 1, "video-seg": 64}
    assets = {n: np.minimum(
        rng.exponential(35, size=s).astype(np.int64), 255)
        for n, s in sizes.items()}
    model = StaticModel.from_symbols(
        np.concatenate(list(assets.values())), 256, params)

    def first_fetches(svc, broker):
        rows = []
        for name, syms in assets.items():
            cap = caps[name]
            t0 = time.perf_counter()
            wire = broker.registry.container_for_threads(name, cap)
            out = svc.submit(name, cap, deadline="interactive").result()
            out = out.cpu().numpy()
            dt = (time.perf_counter() - t0) * 1e3
            assert (out == syms).all(), name
            rows.append((name, cap, len(wire), dt))
        return rows

    def build(predictive):
        svc = DecodeService(model, device=device, max_delay_ms=1e9)
        svc.ingest_batch(assets, 64)
        return svc, svc.start_pipeline(predictive=predictive)

    print("\npredictive hot-set serving (skewed population, cold first "
          "fetches):")
    svc, broker = build(predictive=False)
    with broker:
        reactive = first_fetches(svc, broker)

    svc, broker = build(predictive=True)
    with broker:
        # A Zipf-skewed request log declares the hot set — in production
        # this is live traffic; anticipate() stands in for the history.
        for name in rng.choice(list(assets), p=(0.6, 0.3, 0.1), size=64):
            broker.anticipate(str(name), caps[str(name)])
        units = broker.speculate()   # idle-gap work, off the request path
        compiles_before = svc.stats.compiles
        predictive = first_fetches(svc, broker)
        new_compiles = svc.stats.compiles - compiles_before
        heat = broker.snapshot()["heat"]["top"]

    print("  heat ranking: " + ", ".join(
        f"{h['name']}@{h['n_threads']} ({h['heat']:.0f})" for h in heat))
    print(f"  {units} speculative units ran in idle gaps "
          f"(prethin + container pack + shape warm)")
    for (name, cap, wire_r, dt_r), (_, _, wire_p, dt_p) in zip(
            reactive, predictive):
        assert wire_r == wire_p   # same downscaled container either way
        print(f"  {name:10s} @{cap:3d} threads  {wire_r:>8,} B on wire   "
              f"first fetch {dt_r:7.1f} ms reactive -> {dt_p:6.1f} ms "
              f"predictive ({dt_r / dt_p:5.1f}x)")
    total_r = sum(r[3] for r in reactive)
    total_p = sum(p[3] for p in predictive)
    print(f"  hot set total: {total_r:.0f} ms -> {total_p:.0f} ms "
          f"({total_r / total_p:.1f}x), {new_compiles} compiles in the "
          f"predictive window")

    observability_demo(device)


def observability_demo(device):
    """End-to-end ticket tracing + the unified metrics surface: every
    ticket carries a span tree — admission, lane queue wait, coalesce,
    dispatch, executor run, delivery — whose spans tile its lifetime
    exactly, so "where did this request's latency go" is answerable per
    ticket, not just in aggregate.  The same service exposes one
    ``metrics()`` snapshot unifying service/engine/broker/registry/
    predictor counters with per-class deadline-miss accounting."""
    from repro_torch.runtime.observability import waterfall
    from repro_torch.runtime.pipeline import ControllerConfig
    from repro_torch.runtime.serve import DecodeService

    rng = np.random.default_rng(29)
    params = RansParams(n_bits=11, ways=32)
    assets = {f"asset{i}": np.minimum(
        rng.exponential(35, size=6_000).astype(np.int64), 255)
        for i in range(4)}
    model = StaticModel.from_symbols(
        np.concatenate(list(assets.values())), 256, params)
    svc = DecodeService(model, device=device, max_delay_ms=1e9)
    svc.ingest_batch(assets, 64)

    print("\nobservability (per-ticket span waterfall + unified metrics):")
    with svc.start_pipeline(config=ControllerConfig(
            max_batch=4, batch_sizes=(4,), target_delay_ms=5.0)) as broker:
        names = list(assets)
        for _ in range(2):                 # warm the fused group shape
            for t in [svc.submit(n, 8) for n in names]:
                t.result(timeout=120)
        tickets = [broker.submit(n, 8, deadline="interactive")
                   for n in names]
        for name, t in zip(names, tickets):
            out = t.result(timeout=120).cpu().numpy()
            assert (out == assets[name]).all()
        print()
        print(waterfall(tickets[0].trace))
        snap = svc.metrics()
        deadline = broker.snapshot()["deadline"]
    lat = snap["recoil_request_latency_ms"]["values"]
    ok = lat.get("decode|ok", {"count": 0, "sum": 0.0})
    print(f"\n  unified snapshot: {len(snap)} metric families")
    print(f"  decode ok latency: {ok['count']} requests, "
          f"mean {ok['sum'] / max(ok['count'], 1):.2f} ms")
    for cls, d in sorted(deadline.items()):
        print(f"  deadline class {cls!r}: {d['fulfilled']} fulfilled, "
              f"{d['missed']} missed")
    prof = svc.obs.profiler.snapshot(top=1)["decode"]
    print(f"  decode executor: {prof['compiles']} compiles "
          f"({prof['compile_s'] * 1e3:.0f} ms), {prof['runs']} runs "
          f"({prof['run_s'] * 1e3:.0f} ms)")


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the content and its frequency table made on the card from the
seed, the program's service, the cell's own plans and launches warmed) is
timed as ``setup_s``; then the cell's traffic runs for ``--seconds``; then,
once the window has closed and the memory peak is read, the plain reference
in ``reference.py`` judges what the timed path produced.  With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the per-layer
metrics; with ``--trace 0``, the end-to-end ones.  The last line on standard
output is one JSON object; the numbers compared for ``correct`` are also
the last lines on standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import (content, manifest, reference, roofline,  # noqa: E402
                   stats, traffic)
from bench.tracing import span, summarize  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CHECK_SAMPLE = 8        # outputs of the window, drawn from the seed, checked


@dataclasses.dataclass
class Run:
    """What a metric reader reads (``bench/metrics/<metric>.py``)."""
    setup_s: float
    reqs: list                       # traffic.Req, every request issued
    raw_bytes: dict                  # asset -> bytes
    walk_bytes: dict                 # (asset, threads) -> roofline bytes
    wire_ratio_pct: float | None
    peak_window_bytes: int
    trace: object                    # tracing.Summary, or None


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _model(cfg: dict, n_bits: int):
    from repro_torch.core.rans import RansParams, StaticModel, build_cdf
    f = content.quantize(content.pmf(cfg["content"]["distribution"]), n_bits)
    f32 = f.astype(np.uint32)
    params = RansParams(n_bits=n_bits, ways=int(cfg["codec"]["ways"]))
    return f, StaticModel(f=f32, F=build_cdf(f32), params=params)


def _container_faults(c, full, freqs, n_symbols: int, threads: int) -> int:
    """Ways a thinned container fails to be the full one less entries:
    the same payload, the thread count asked for, its entries a subset."""
    bad = int(not np.array_equal(c.freqs, freqs))
    bad += int(c.n_symbols != n_symbols or c.n_words != full.n_words
               or not np.array_equal(c.words, full.words)
               or not np.array_equal(c.finals, full.finals))
    bad += int(c.n_threads != min(threads, full.n_threads))
    at = {int(q): e for e, q in enumerate(full.offsets)}
    for e, q in enumerate(c.offsets):
        j = at.get(int(q))
        if j is None or not (np.array_equal(c.ks[e], full.ks[j])
                             and np.array_equal(c.ys[e], full.ys[j])):
            bad += 1
    return bad


def _stream(c) -> reference.Stream:
    return reference.Stream(words=torch.as_tensor(c.words.astype(np.int32)),
                            finals=c.finals, offsets=c.offsets, ks=c.ks,
                            ys=c.ys, n_symbols=c.n_symbols)


def _pack(words_u16, finals, plan, model, threads: int) -> bytes:
    """The program's own packer, at ``threads`` (its plan thinned by the
    program's ``combine_plan``)."""
    from repro_torch.core import container, recoil
    from repro_torch.core.interleaved import EncodedStream
    enc = EncodedStream(stream=words_u16, final_states=finals,
                        n_symbols=plan.n_symbols, params=model.params,
                        k_of_word=None, y_of_word=None)
    return container.pack_recoil(enc, model,
                                 recoil.combine_plan(plan, threads))


def _judge_containers(full_bufs: dict, plans: dict, model, freqs, classes,
                      files, device):
    """Wire containers at each client class, packed by the program from
    each content's full container, parsed and held to the full one, and
    every full container decoded by the reference.  Returns the checks'
    counts and each (content, class)'s sizes."""
    bad_containers, sizes, streams, want = 0, {}, [], []
    for i, buf in full_bufs.items():
        full = reference.parse_container(buf)
        streams.append(_stream(full))
        want.append(files[i])
        for t in classes:
            try:
                c = reference.parse_container(
                    _pack(full.words.copy(), full.finals.astype(np.uint32),
                          plans[i], model, t))
            except ValueError:
                bad_containers += 1
                continue
            bad_containers += _container_faults(c, full, freqs,
                                                files[i].numel(), t)
            sizes[(i, t)] = c
    v = reference.walk(streams, freqs, model.params.n_bits,
                       model.params.ways, device)
    wrong = reference.wrong_symbols(v.symbols, torch.cat(want))
    return {"ref_wrong_symbols": wrong, "bad_ends": v.bad_ends,
            "bad_containers": bad_containers}, sizes


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", rehearse: bool = False,
             control: bool = False) -> dict:
    """Run the cell once; returns the result line's object.  ``rehearse``
    takes the workload file's ``rehearsal`` sizes (for the plain walks on
    the CPU); ``device="cpu"`` skips everything that reads the card.
    ``setup_s`` counts from the process's start: the benchmark's runs are one
    cell a process.
    ``control`` runs the cell's control (``control.py``): the reference at
    the precision below the configuration's in place of the program's
    decodes, judged at the stated precision."""
    from repro_torch.core import container
    from repro_torch.core.encode import EncoderSession
    from repro_torch.runtime.serve import DecodeService
    cell = manifest.cell(name)
    cfg, mix = cell.config, cell.workload["mix"]
    if rehearse:
        cfg = _merge(cfg, cell.workload["rehearsal"].get("config", {}))
        mix = _merge(mix, cell.workload["rehearsal"].get("mix", {}))
    on_card = torch.device(device).type == "cuda"
    codec, cont = cfg["codec"], cfg["content"]
    n_bits, n_splits = int(codec["n_bits"]), int(codec["n_splits"])
    n_bytes = int(cont["n_bytes"])
    freqs, model = _model(cfg, n_bits)
    svc = DecodeService(model, device=device)
    classes = sorted({int(t) for t in mix["threads"]})
    files = content.draw(cont["distribution"], int(cont["n_files"]),
                         n_bytes, seed, device)
    names = [f"a{i}" for i in range(len(files))]
    full_bufs, plans = {}, {}
    coder = EncoderSession(model, device=device)
    for i, f in enumerate(files):
        buf, _ = coder.ingest_container(f, n_splits)
        parsed = container.parse(buf, model.params)
        svc.register(names[i], parsed.plan, parsed.stream,
                     parsed.final_states, model=parsed.model)
        full_bufs[i], plans[i] = buf, parsed.plan
    del coder
    for nm in names:
        for t in classes:
            svc.prepare_request(nm, t)
            svc.decode(nm, t)
    _sync(device)
    gc.collect()
    pre_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    compiles = svc.stats.compiles
    setup_s = time.perf_counter() - T_START

    pauses = []
    gc_clock = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_clock["t"] = time.perf_counter()
        elif "t" in gc_clock:
            pauses.append((info["generation"],
                           time.perf_counter() - gc_clock.pop("t")))
    gc.callbacks.append(on_gc)
    cpu0, wall0 = time.process_time(), time.perf_counter()
    prof = None
    if trace and on_card:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    sample = traffic.Reservoir(CHECK_SAMPLE, seed)
    with span("window", prof is not None):
        reqs = traffic.closed_decode(svc, names, mix, seconds, seed,
                                     prof is not None, sample)
        _sync(device)
    if prof is not None:
        prof.stop()
    gc.callbacks.remove(on_gc)
    cpu_s, wall_s = time.process_time() - cpu0, time.perf_counter() - wall0
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    new_compiles = svc.stats.compiles - compiles
    summary = summarize(prof) if prof is not None else None
    del prof

    # The check, once the window has closed and the peak is read: the
    # program's outputs are judged by the reference.
    checks = {}
    del svc
    gc.collect()
    raw = {i: int(f.numel()) for i, f in enumerate(files)}
    counts, sizes = _judge_containers(full_bufs, plans, model, freqs,
                                      classes, files, device)
    held = list(sample.items)
    if control:
        # The reference at the precision below the stated one, in the
        # program's place, on the containers each request was served.
        f_lo = content.quantize(
            content.pmf(cfg["content"]["distribution"]), n_bits - 1)
        held = [(r, reference.walk([_stream(sizes[(r.asset, r.threads)])],
                                   f_lo, n_bits - 1, model.params.ways,
                                   device).symbols) for r, _ in held]
    checks["wrong_symbols"] = sum(
        reference.wrong_symbols(out, files[r.asset]) for r, out in held)
    checks["checked_outputs"] = len(held)
    checks.update(counts)
    walk_bytes = {k: roofline.walk_bytes(c.n_words, c.metadata_bytes,
                                         c.table_bytes, c.n_symbols)
                  for k, c in sizes.items()}
    wire = None
    if reqs and all((r.asset, r.threads) in sizes for r in reqs):
        wire = 100.0 * sum(sizes[(r.asset, r.threads)].size
                           for r in reqs) / sum(raw[r.asset] for r in reqs)

    run = Run(setup_s=setup_s, reqs=reqs, raw_bytes=raw,
              walk_bytes=walk_bytes, wire_ratio_pct=wire,
              peak_window_bytes=window_peak, trace=summary)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = dict(cell.workload["limits"])
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()
                if k in limits}
    attempted = len(reqs)
    failed = sum(r.status != "ok" for r in reqs)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name()
                            if on_card else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": max(pre_peak, window_peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops,
                               "idle_gaps": summary.idle_gaps}
    result["notes"] = {
        "card": roofline.card() if on_card else "cpu",
        "roofline_peak": roofline.PEAK_BASIS,
        "launchers_resolved_in_window": new_compiles,
        "checked": {k: v for k, v in checks.items() if k not in limits},
        "gc_pauses_ms": {
            "count": len(pauses),
            "gen2": sum(g == 2 for g, _ in pauses),
            "total": 1e3 * sum(p for _, p in pauses),
            "max": 1e3 * max((p for _, p in pauses), default=0.0)},
        "call_ms": _spread_ms([r.enqueue_s for r in reqs]),
        "process_cpu_s": cpu_s, "window_wall_s": wall_s,
        "latency_ms": _latencies(reqs)}
    result["checks"] = compared
    return result


def _latencies(reqs) -> dict | None:
    """p50 / p95 / p99 (nearest rank) of the requests, from issue to
    ready (ms)."""
    lat = [(r.done - r.due) * 1e3 for r in reqs if r.status == "ok"]
    if not lat:
        return None
    return {f"p{q}": stats.nearest_rank(lat, q) for q in (50, 95, 99)}


def _spread_ms(seconds: list) -> dict | None:
    """p50 / p99 / max of host times (ms)."""
    if not seconds:
        return None
    ms = [1e3 * s for s in seconds]
    return {"p50": stats.nearest_rank(ms, 50),
            "p99": stats.nearest_rank(ms, 99), "max": max(ms)}


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

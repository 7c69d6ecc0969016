"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``) — nothing of JAX or of the JAX
package — in five phases, each failing loudly with a non-zero exit:

  1. device  — the card's name, count, and ``nvidia-smi`` name/power limit;
  2. build   — one ``nvcc`` for the kernel source, with its ``-Xptxas -v``
               register and shared-memory report;
  3. kernels — each walk kernel against its plain torch version on the card
               over W {8..128}, n_bits {11, 16}, packed and three-table
               slot tables, u16 and u32 permutations: outputs must be equal;
  4. main    — the content-delivery path at the paper's size (§5.1 Table 4:
               10 MB assets; Table 3 codec n = 11, W = 32; a 2176-thread
               split plan).  Two assets are encoded on the host; one is
               registered with its emission log (symbol layout), the other
               through the wire container with none (pointer layout); the
               DecodeService on the card decodes each at 16, 128 and 2176
               threads and a fused group of 8 mixed requests.  Every result
               must equal the input symbols, both kernels must have launched
               and the plain walk must have served nothing;
  5. times   — each kernel at the main path's 2176-thread shapes: checked
               against its plain version, then warm CUDA-event times of the
               kernel and the plain version, the byte bound, decoded MB/s.

Prints, before the last line, the kernel table as one JSON object and the
card's ``nvidia-smi`` line; the last line is the JSON run summary.  Exits
non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
MB = 1_000_000
N_BITS, WAYS, PLAN_THREADS = 11, 32, 2176
THREADS = (16, 128, 2176)
LATENCY_REPS = 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# 32-bit arithmetic outside the tensor cores: the data sheet's 67 TFLOP/s
# float32 rate, the highest such rate the card has.  A decode step is about
# a dozen such operations per symbol (mask, unpack, multiply, shift, add,
# compares, renormalization shift/or, the keep test).
INT32_OPS_PER_S = 67e12
OPS_PER_SYMBOL = 12
KERNEL_SOURCE = "src/repro_torch/kernels/rans_decode/csrc/rans_walk.cu"
REPLACES = {
    "walk_pointer": "src/repro/kernels/rans_decode/rans_decode.py:93",
    "walk_symbol": "src/repro/kernels/rans_decode/rans_decode.py:153",
}


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` warm calls, by CUDA
    events around the whole run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build(rd) -> None:
    t = time.perf_counter()
    rd.build_library()
    rd.load_library()
    log(f"[build] nvcc + load {time.perf_counter() - t:.1f} s")
    for line in rd.ptxas_report().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("[build] " + line.strip())


def _content(seed, n, ways, n_bits, n_splits):
    from repro_torch.core import recoil
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.exponential(40.0, size=n).astype(np.int64), 255)
    model = StaticModel.from_symbols(np.concatenate([syms, np.arange(256)]),
                                     256, RansParams(n_bits=n_bits, ways=ways))
    enc = encode_interleaved_fast(syms, model)
    plan = recoil.plan_splits(enc, n_splits)
    batch = WalkBatch.from_splits(
        recoil.build_split_states(plan, enc.final_states), ways)
    return syms, model, enc, batch


def _compare(name, got, want, errs) -> None:
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    errs[name] = max(errs.get(name, 0), err)
    if err != 0:
        fail(f"{name} disagrees with its plain version (max |err| {err})")


def phase_kernels(dev, errs) -> None:
    from repro_torch.core.engine import (SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS,
                                         pad_split_arrays)
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl,
                                             words_by_symbol_host)
    from repro_torch.kernels.rans_decode.ops import _luts, packed_lut_ok
    from repro_torch.kernels.rans_decode.rans_decode import (
        walk_decode_pointer, walk_decode_symbol)
    cases = 0
    for ways in (8, 16, 32, 64, 128):
        for n_bits in (11, 16):
            syms, model, enc, batch = _content(ways * 100 + n_bits, 40_000,
                                               ways, n_bits, 61)
            n = len(syms)
            arrs = pad_split_arrays(batch, batch.k.shape[0], dev)
            st = dict(n_bits=n_bits, ways=ways, n_steps=batch.n_steps,
                      n_symbols=n)
            words = torch.as_tensor(enc.stream.astype(np.int32), device=dev)
            wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
            wbs = np.concatenate([wbs, np.zeros((-n) % ways, np.uint32)])
            for packed in sorted({False, packed_lut_ok(model)}):
                luts = _luts(model, packed, dev)
                a = (words, *luts, *(arrs[f] for f in SPLIT_FIELDS))
                out, qf = walk_decode_pointer(*a, **st)
                ref, ref_qf = _walk_batch_impl(*a, **st)
                _compare("walk_pointer", out, ref, errs)
                _compare("walk_pointer", qf, ref_qf, errs)
                for perm, view in ((np.uint16, np.int16),
                                   (np.uint32, np.int32)):
                    by = torch.as_tensor(wbs.astype(perm).view(view),
                                         device=dev)
                    a = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
                    _compare("walk_symbol", walk_decode_symbol(*a, **st),
                             _walk_batch_symbol_impl(*a, **st), errs)
                cases += 1
                if not (out.cpu().numpy() == syms).all():
                    fail(f"kernel decode != symbols (W={ways}, n={n_bits})")
    torch.cuda.synchronize()
    log(f"[kernels] {cases} table/width cases x (pointer + u16 + u32 symbol) "
        f"equal their plain versions; max |err| {errs}")


def _assets():
    from repro_torch.core.rans import RansParams, StaticModel
    rng = np.random.default_rng(100)       # rand_exponential(100), 10 MB
    expo = np.minimum(rng.exponential(scale=2550.0 / 100, size=10 * MB),
                      255).astype(np.int64)
    rng = np.random.default_rng(42)        # Zipf bytes, a = 1.5, 10 MB
    zipf = np.minimum(rng.zipf(1.5, size=10 * MB) - 1, 255).astype(np.int64)
    counts = np.bincount(expo, minlength=256) + np.bincount(zipf, minlength=256)
    model = StaticModel.from_counts(counts, RansParams(n_bits=N_BITS,
                                                       ways=WAYS))
    return {"expo": expo, "zipf": zipf}, model


def phase_main(dev, rd):
    from repro_torch.core import container, recoil
    from repro_torch.core.vectorized import encode_interleaved_fast
    from repro_torch.runtime.serve import DecodeService
    assets, model = _assets()
    t = time.perf_counter()
    enc = {k: encode_interleaved_fast(v, model) for k, v in assets.items()}
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    plans = {k: recoil.plan_splits(e, PLAN_THREADS) for k, e in enc.items()}
    t_plan = time.perf_counter() - t
    wire = container.pack_recoil(enc["zipf"], model, plans["zipf"])
    parsed = container.parse(wire, model.params)
    log(f"[main] host encode {t_enc:.2f} s, plan {t_plan:.2f} s for 2 x 10 MB; "
        f"words {enc['expo'].n_words} + {enc['zipf'].n_words}; "
        f"{PLAN_THREADS}-thread plans; zipf container {len(wire)} B")
    want = {k: torch.as_tensor(v.astype(np.int32), device=dev)
            for k, v in assets.items()}

    rd.reset_counts()
    svc = DecodeService(model, device=dev)
    svc.register("expo", plans["expo"], enc["expo"].stream,
                 enc["expo"].final_states, model=model,
                 emission_log=enc["expo"].k_of_word)
    svc.register("zipf", parsed.plan, parsed.stream, parsed.final_states,
                 model=parsed.model)
    layouts = {k: svc.layout_for(k) for k in assets}
    if layouts != {"expo": "symbol", "zipf": "pointer"}:
        fail(f"unexpected layouts {layouts}")
    for th in THREADS:
        for name in assets:
            if not torch.equal(svc.decode(name, th), want[name]):
                fail(f"{name} at {th} threads != input symbols")
    reqs = [("expo", 2176), ("zipf", 2176), ("expo", 128), ("zipf", 128),
            ("expo", 16), ("zipf", 16), ("zipf", 2176), ("expo", 128)]
    tickets = [svc.submit(n, th) for n, th in reqs]
    svc.flush()
    for (name, th), tk in zip(reqs, tickets):
        if not torch.equal(tk.result(), want[name]):
            fail(f"fused {name} at {th} threads != input symbols")
    torch.cuda.synchronize()
    launches = {"walk_pointer": rd.walk_decode_pointer.launches,
                "walk_symbol": rd.walk_decode_symbol.launches}
    plain = (rd.walk_decode_pointer.plain_calls
             + rd.walk_decode_symbol.plain_calls)
    stats = svc.stats.snapshot()
    log(f"[main] layouts {layouts}; launches {launches}; plain walks {plain}; "
        f"service {stats}")
    if min(launches.values()) == 0 or plain != 0:
        fail("the main path did not run on both kernels alone")
    if stats["fused_dispatches"] != 1 or stats["pointer_plans"] < 4:
        fail("the mixed group did not fuse into one pointer-layout dispatch")

    # Warm end-to-end request latency (host clock around decode + sync).
    for name in assets:
        for th in THREADS:
            svc.decode(name, th)
            torch.cuda.synchronize()
            times = []
            for _ in range(LATENCY_REPS):
                t = time.perf_counter()
                svc.decode(name, th)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            med = statistics.median(times) * 1e3
            log(f"[main] warm decode {name} ({layouts[name]}) at {th} threads: "
                f"median {med:.3f} ms of {LATENCY_REPS}, "
                f"{len(assets[name]) / med / 1e3:.1f} MB/s")
    return svc, assets, enc, launches


def _bound(plan, n_words, n_symbols) -> dict:
    """Least time for the walk on this run's data: the larger of

      * bytes — what the function needs, not what the plan's buckets hold:
        each 16-bit stream word read once (2 B, whatever the layout's
        storage), the slot tables and the real splits' metadata (padding
        rows excluded) read once, the n_symbols int32 outputs (and the
        pointer walk's int32 qf per real split) written once, over the
        HBM rate;
      * operations — OPS_PER_SYMBOL 32-bit integer operations for every
        symbol a split walks (``start - stop + 1`` per real split), over
        the card's 32-bit non-tensor peak.

    Also returns the deepest real split's step count (the kernels stop
    there; the plan's bucketed count is an upper bound).
    """
    luts = plan.args[1:4]
    splits = plan.args[4:]
    g_hi, start, stop = (splits[i].to(torch.int64) for i in (4, 5, 6))
    real = start >= 0
    real_rows = int(real.reshape(real.shape[0], -1).any(1).sum())
    row_bytes = sum(t[0].numel() * t.element_size() for t in splits)
    nbytes = (n_words * 2
              + sum(t.numel() * t.element_size() for t in luts
                    if t is not None)
              + real_rows * row_bytes
              + n_symbols * 4
              + (real_rows * 4 if plan.layout == "pointer" else 0))
    walked = int(((start - stop + 1) * real).sum())
    steps = int(((g_hi - stop // plan.statics["ways"] + 1) * real).max())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = walked * OPS_PER_SYMBOL / INT32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, bytes_ms=bytes_ms, ops_ms=ops_ms, steps=steps,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_times(svc, assets, enc, launches, errs, smi):
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl)
    rows = []
    for kname, name in (("walk_symbol", "expo"), ("walk_pointer", "zipf")):
        plan = svc.prepare_request(name, PLAN_THREADS)
        if {"walk_symbol": "symbol",
                "walk_pointer": "pointer"}[kname] != plan.layout:
            fail(f"{name} planned on {plan.layout}")
        kern = svc.session.executor.lower(plan)
        plain_fn = (_walk_batch_symbol_impl if plan.layout == "symbol"
                    else _walk_batch_impl)
        got = kern(*plan.args)
        ref = plain_fn(*plan.args, **plan.statics)
        if plan.layout == "pointer":
            _compare(kname, got[1], ref[1], errs)
            got, ref = got[0], ref[0]
        _compare(kname, got, ref, errs)
        ms = cuda_ms(lambda: kern(*plan.args), 20)
        plain_ms = cuda_ms(lambda: plain_fn(*plan.args, **plan.statics), 2)
        b = _bound(plan, enc[name].n_words, len(assets[name]))
        n_splits = plan.args[4].shape[0]
        log(f"[times] {kname} on {name}: {PLAN_THREADS} threads, {b['steps']} "
            f"steps (bucket {n_splits} rows x {plan.statics['n_steps']} "
            f"steps), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
            f"{b['bytes_ms']:.4f} ms = {b['bytes']} B, operations "
            f"{b['ops_ms']:.4f} ms), "
            f"{len(assets[name]) / ms / 1e3:.1f} MB/s decoded; card: {smi}")
        rows.append({"name": kname, "route": "cuda", "source": KERNEL_SOURCE,
                     "replaces": REPLACES[kname],
                     "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "library_ms": None})
    return rows


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, SRC)
    from repro_torch.kernels.rans_decode import rans_decode as rd
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build(rd)
    errs: dict = {}
    phase_kernels(dev, errs)
    svc, assets, enc, launches = phase_main(dev, rd)
    rows = phase_times(svc, assets, enc, launches, errs, smi)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives only the port (``src/repro_torch``) — nothing of JAX or of the JAX
package — in seven phases, each failing loudly with a non-zero exit:

  1. device  — the card's name, count, and ``nvidia-smi`` name/power limit;
  2. build   — one ``nvcc`` per kernel source, started together, with each
               ``-Xptxas -v`` register and shared-memory report (the walks'
               as one line of registers per kernel and slot table over
               their (W, block) instances, and the default 128-thread
               launch's on a line of its own), and, read
               from the encode kernel's SASS, the instructions its chain
               warp issues a step and those on the state's chain;
  3. kernels — each kernel against its plain torch version on the card.
               Walks: W {8..128}, n_bits {11, 16}, packed and three-table
               slot tables, on int16 streams and permutations: many short
               splits, and a few long ones that cross hundreds of ring
               refills, read down to word 0 and run on streams whose length
               is not a multiple of 8, with inert padding rows under
               ``covered``.  Then both walks through a card session,
               each executor call against its plain walk: n_bits 8 and 14
               at W 8, 32, 128, a 4096-symbol alphabet at n = 14 (three
               tables), ``decode_conventional`` (pointer) and the four
               ``tests/golden`` wire vectors (both layouts).
               Encode scan: W {8..128} x n_bits {11, 12, 16},
               lengths under W and off a multiple of W, resume lead slots
               with a random x0; group counts around the kernel's chunk and
               ring; ragged batches of 5 contents, static and adaptive, at
               W 8 and 128; a 4096-symbol alphabet at n = 12 (table in
               shared memory) and a 5000-symbol one at n = 13 (through the
               read-only cache); an adaptive context map; zero-frequency
               and out-of-alphabet symbols that must raise the flag, one at
               a state of 0; the caller's encoder table, and one for
               another n_bits, which must be refused.  Split planner (its
               cover, chain and emit kernels): also against the port's
               ``heuristic.plan_split_offsets``, on a case that needs window
               expansion, plans of up to 2176 threads, a window-2 case whose
               slots are won in later rounds and a ragged batch of three
               contents; the cover kernel alone against
               ``plan_cover_plain`` on every word.  Outputs must be equal;
  4. main    — the content-delivery path at the paper's size (§5.1 Table 4:
               10 MB assets; Table 3 codec n = 11, W = 32; a 2176-thread
               split plan), starting from raw symbols on the card.  One asset
               enters through ``DecodeService.ingest`` (symbol layout); the
               other is encoded and split-planned by the port's
               ``EncoderSession`` on the card, packed into the wire container,
               parsed and registered with no emission log (pointer layout).
               Both are held against the host encoder and ``plan_splits``
               (stream words, emission log, final states, every split point,
               permutation), then decoded at 16, 128 and 2176 threads and in
               a fused group of 8 mixed requests.  Streaming: at each thread
               count, 1, 3 and 8 chunks through ``decode_chunks`` and
               ``submit_stream`` must equal their slices of the symbols and
               concatenate to ``decode``, the chunk specs must tile the asset
               with ``words_end`` rising to the stream's length, every chunk
               plan must be covered, and a second, warm round of streams must
               resolve no launcher; zipf re-packed as an 8-chunk wire
               container must decode each chunk from a stream on the card
               holding only that chunk's ``words_end`` words.  The group
               backend: ``dispatch_group`` of the 8 mixed requests must equal
               ``submit``/``flush``, and ``prepare_group`` must count no
               dispatch.  Faults: a ``drop_last_word`` corruption armed at
               ``service.register`` must make ``register`` of a resident
               stream raise, and a ``service.dispatch_stream`` fault must
               reach the ticket's first chunk; ``metrics_text()`` must show
               stream requests and profiler runs of both sessions.
               ``extend`` (9 MB + 1 MB) must equal the full ingest and the
               reference's extend points, and ``ingest_batch`` of three
               contents the three single ingests.  The serving pipeline
               (``start_pipeline``, max_batch 8), warmed over both assets
               at 16, 128 and 2176 threads: 64 requests mixed over both
               names, the thread counts and three deadline classes must
               equal their assets and resolve no launcher, while its ingest
               worker ingests 9 MB of expo; an extend by the last 1 MB with
               decodes of that content in flight, each the old content or
               the new, and a third 10 MB asset (seed 101), both equal to
               the host reference; a decode right after each ingest ticket;
               streams of 8 chunks through the broker; ``speculate`` ahead
               of a new pair's first request (a memo hit, no launcher);
               a ``broker.decode_worker`` crash the supervisor recovers, a
               ``service.execute`` fault retried to success, a cancel
               before dispatch; ``submitted == completed + cancelled``
               and nonzero broker counts in ``metrics_text()``; the
               ``warm()`` calls' groups, wall time and launches' device time
               are printed.  Every decode must equal
               the input symbols, all four kernels must have launched, no
               plain version may have served, every single-content plan must
               be covered (no -1 fill) and the fused plan's coverage must be
               what an independent check of its windows says;
  5. times   — each walk kernel at the main path's 16-, 128- and 2176-thread
               plans: the executor's call, the one the main path makes,
               checked against the input symbols and against its plain
               version on the same arguments (output and final pointers),
               then its CUDA-event device time, per-step time and the bound;
               a separate line gives a model of the bytes the rings copy
               (from their geometry, not a counter); at 2176 threads, the
               plain version's time.  Streaming at 16 and 2176 threads in 8
               chunks: the device time from the first chunk's launch to
               the end of chunk 0 and of the last chunk (the phase's own
               timing events after each launch), beside the whole-asset
               decode's device time and ``submit_stream``'s host enqueue
               time (medians).  At 2176 threads, the instrumentation's host
               cost: the warm ``decode`` and ``submit_stream`` on the main
               service (``observe=True``) and on one with ``observe=False``
               serving the same content, interleaved (medians).  The
               pipeline broker on expo at 16 and 2176 threads: a closed
               loop of 200 requests, ``submit`` to ``result()``, p50 and
               p99, interleaved with the sync path's ``decode``, first on
               an idle ingest worker with the predictor off, then with it
               on, then while the ingest worker ingests a 10 MB asset back
               to back (with the broker's overlap ratio and wait/service
               summaries, the groups, wall time and launches' device time
               of the ``warm()`` before each loop, and the predictor's
               units during it); and ``submit_stream`` in 8 chunks
               through the broker and direct, host time to chunk 0 and to
               the last chunk (medians).  Then the warm ``ingest`` latency of
               each 10 MB asset and the ``extend`` latency of the 1 MB delta
               (host clock around the call and a synchronize, median of 5),
               and each ingest kernel's CUDA-event device time at the main
               path's shapes (the encode with the executor's encoder table,
               as the main path calls it; its cycles a group step) beside
               its bound and its plain version's time; for the planner
               also its time a slot, the design's own model, the split of
               its device time between its three kernels (``torch.profiler``)
               and the round in which each slot was won;
  6. tuning  — both walks at every ``rows_per_block`` W = 32 allows (1, 2,
               4, 8, 16, 32 warps and None) on the main path's 16-, 128-
               and 2176-thread plans, each launch bit-equal to the plain
               walk, the default launch and the symbols, with its
               CUDA-event time; then, with the counts at 0,
               ``Autotuner(device="cuda")`` on 1, 4 and 10 MB requests with
               2176-split plans into a temporary database (never the user
               cache): measurements > 0 under ``cuda:cuda:auto``, the fit
               and the derived ladder printed, and a second tuner on the
               same workload with 0 measurements; a ``REPRO_TUNING_DB``
               that fails to load must raise; a ``DecodeService`` with
               that profile ingests expo and registers zipf's resident
               stream, decodes both at 16, 128 and 2176 threads and in a
               fused group, bit-equal, twice (the warm round resolving no
               launcher), and its broker takes the profile's microbatch
               sizes.  This path's launches join the kernel table's;
  7. shards  — the sharded executor on meshes that repeat the one card,
               ``(cuda:0,) * k`` for k in 1, 2, 4 and the 2 x 2 smoke mesh:
               both assets at 16, 128 and 2176 threads, each decode equal
               to the symbols and the main service's unsharded decode, with
               each shard's real rows (held to the reference's partition
               formula), the words it reads against the stream's or
               permutation's bucket, its step count and its own launch; a
               warm round resolves no launcher.  A sharded
               ``DecodeService`` (4 entries, microbatch 8) runs a fused
               group twice (2 fused dispatches, 1 launcher, 1 cache hit)
               and the broker stress of ``tests/test_pipeline.py``
               (concurrent submits during re-ingests of 3 contents, every
               result bit-exact, no dispatch or ingest error); then both
               examples run through their ``main()`` (their lines are in
               the log).  This path's launches join the kernel table's.
               Then CUDA-event times: each request's sharded decode at
               k = 1, 2, 4 beside the unsharded one, and each shard's walk
               alone.  One card runs a mesh's shards one after another, so
               these time the partition, fills and merge, not scaling.

Prints, before the last line, the kernel table as one JSON object and the
card's ``nvidia-smi`` line; the last line is the JSON run summary.  Exits
non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
TESTS = os.path.join(os.path.dirname(SRC), "tests")   # torch_checks.py
MB = 1_000_000
N_BITS, WAYS, PLAN_THREADS = 11, 32, 2176
THREADS = (16, 128, 2176)
LATENCY_REPS = 20
TIME_REPS = 20
# A device-side sleep ahead of each timed run, long enough that the host has
# queued every launch before the first starts: the events then time the
# device alone, not the host's enqueue gaps.
SLEEP_CYCLES = 40_000_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
# 32-bit arithmetic outside the tensor cores: the data sheet's 67 TFLOP/s
# float32 rate, the highest such rate the card has.  A decode step is about
# a dozen such operations per symbol (mask, unpack, multiply, shift, add,
# compares, renormalization shift/or, the keep test).
INT32_OPS_PER_S = 67e12
OPS_PER_SYMBOL = 12
SOURCES = {
    "walk_pointer": "src/repro_torch/kernels/rans_decode/csrc/rans_walk.cu",
    "walk_symbol": "src/repro_torch/kernels/rans_decode/csrc/rans_walk.cu",
    "encode_scan": "src/repro_torch/kernels/rans_encode/csrc/rans_encode.cu",
    "plan_splits": "src/repro_torch/kernels/rans_encode/csrc/rans_encode.cu",
}
REPLACES = {
    "walk_pointer": "src/repro/kernels/rans_decode/rans_decode.py:93",
    "walk_symbol": "src/repro/kernels/rans_decode/rans_decode.py:153",
    "encode_scan": "src/repro/core/encode/ops.py:78",
    "plan_splits": "src/repro/core/encode/ops.py:227",
}
INGEST_REPS = 5
# Streaming: the chunk counts phase 4 checks, and phase 5's timed stream.
CHUNK_COUNTS = (1, 3, 8)
STREAM_CHUNKS = 8
STREAM_THREADS = (16, 2176)
OBSERVE_THREADS = 2176  # the instrumentation's host cost weighs most here
# The pipeline broker's closed loop: requests, each submitted once the one
# before has returned, interleaved with the sync path's decode.
BROKER_REPS = 200
# The ingest path's assets: the first 9 MB of one asset is ingested and then
# extended by the last 1 MB.
EXTEND_AT = 9 * MB
WINDOW = 96                   # the Def-4.1 half-window (heuristic default)
# The encode's chain, a model of the function.  A way's steps are
# sequential (each step's state is the next step's input), so a content
# takes at least G times the dependent latency of one step's state update,
# and an encode that divides by a reciprocal chains at least
# ENCODE_STEP_OPS dependent operations a step: the renormalization compare,
# the select, the multiply-high, the shift and the multiply-add.  Each
# counts CYCLES_PER_DEPENDENT_OP cycles (the CUDA C++ Programming Guide's
# figure for a dependent arithmetic instruction; some, such as IMAD.HI,
# take longer, so the bound is low) at the top SM clock.  Phase 2 also
# reads the chain of the kernel as built, a diagnostic beside the model:
# the instructions of its chunk loop (ENCODE_CHUNK steps) in the SASS on
# the state register's loop-carried dependence chain.
ENCODE_STEP_OPS = 5
ENCODE_CHUNK = 64
# The static kernel with its table in shared memory, by its mangled name
# (template arguments <false, true>, then the parameters up to the table's
# uint4 pointer).
ENCODE_SASS_KERNEL = "encode_scan_kernelILb0ELb1EEEvPKiPKhS2_PK5uint4"
CYCLES_PER_DEPENDENT_OP = 4
# The planner's chain, a model of the function (heuristic.plan_split_offsets,
# a slot whose first round finds a candidate).  Every slot waits for the
# c_prev and min_q of the one before, and a slot's critical path is at least
# PLAN_SLOT_OPS dependent operations -- T (subtract, add, divide), the target,
# the center read, the window's subtract and max and the candidate's index,
# its k_of_word read, the group quotient and the way's select, the last[]
# read, k = g * W + j, h (subtract, abs, add), the winner's c -- plus a
# min/max over the W ways (log2 W levels) and an argmin over the round's
# 2w + 1 candidates (ceil(log2(2w + 1)) levels), each operation
# CYCLES_PER_DEPENDENT_OP cycles.  A memory read counts as one operation,
# so the model is loose.
PLAN_SLOT_OPS = 17
# The planner design's own model (printed beside the bound, which keeps the
# slot-chain basis above): its cover pass's bytes at the HBM rate, plus two
# dependent memory round trips a slot, each PLAN_ROUND_TRIP_CYCLES at the
# top SM clock -- an assumed latency of an L2 hit on Hopper, the model's
# input, not a measurement.
PLAN_ROUND_TRIP_CYCLES = 260
# Ring geometry of csrc/rans_walk.cu at W = 32 (words of one chunk, chunks
# of one ring), for the model of the bytes the rings copy.
POINTER_CHUNK, SYMBOL_ROWS, RING_CHUNKS = 32, 8, 4


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def cuda_ms(fn, reps: int, warm: bool = True) -> tuple[float, float]:
    """Mean device time of ``fn()`` over ``reps`` calls (after one warm-up
    call unless ``warm`` is False), by CUDA events around the whole run,
    queued behind a device sleep so that the events see the device's time
    and not the host's; and the host's mean time to enqueue one call (ms).
    A call that waits on the device (a plain version reading values to the
    host) is timed whole."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) / reps * 1e3
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, host


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


_NO_DEST = {"STG", "STS", "STL", "ST", "RED", "BRA", "EXIT", "BAR", "BSYNC",
            "BSSY", "WARPSYNC", "NOP", "MEMBAR", "CALL", "RET", "DEPBAR",
            "YIELD", "CCTL", "ERRBAR", "FENCE"}
_SASS_REG = re.compile(r"(?<![\w.])(U?[RP])(\d+)(\.64)?")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)\s*([^;]*);")


def _sass_regs(operand: str, width: int = 1) -> list:
    """Registers an operand names: ``R5.64`` and a ``width`` > 1 also
    name the registers after it."""
    out = []
    for kind, num, wide in _SASS_REG.findall(operand):
        n = 2 if wide else width
        out += [f"{kind}{int(num) + i}" for i in range(n)]
    return out


def _sass_instructions(body: str) -> list:
    """``(address, guarded, opcode, dests, sources)`` of each instruction:
    the first operand is written (with the predicates right after it: the
    carry and compare outputs; a PLOP3 writes two), a guard predicate is
    read, and wide operations write register pairs."""
    instrs = []
    for at, guard, opcode, rest in _SASS_INSTR.findall(body):
        ops = [o.strip() for o in rest.split(",")] if rest.strip() else []
        base = opcode.split(".")[0]
        srcs = _sass_regs(guard) if guard else []
        if base in _NO_DEST or not ops:
            n_dest = 0
        elif base == "PLOP3":
            n_dest = 2
        else:
            n_dest = 1
            while n_dest < len(ops) and re.fullmatch(r"U?P(\d|T)",
                                                     ops[n_dest]):
                n_dest += 1
        width = (4 if ".128" in opcode else 2 if ".64" in opcode
                 or ".WIDE" in opcode or base == "CS2R" else 1)
        dests = [r for i, o in enumerate(ops[:n_dest])
                 for r in _sass_regs(o, width if i == 0 else 1)]
        for i, o in enumerate(ops[n_dest:], n_dest):
            wide = ".WIDE" in opcode and i == len(ops) - 1
            srcs += _sass_regs(o, 2 if wide else 1)
        instrs.append((int(at, 16), bool(guard), opcode, dests, srcs))
    return instrs


def _carried_chain(loop: list) -> list:
    """The longest loop-carried dependence chain of ``loop`` (instructions
    in address order, the path that runs every unrolled step): for each
    register the loop reads before it writes it and writes again, the
    longest path of dependent instructions from its value at the loop's
    head to its value at the loop's end.  Returns its opcodes."""
    written, carried = set(), []
    for _, _, _, dests, srcs in loop:
        carried += [r for r in srcs if r not in written and r not in carried]
        written.update(dests)
    best: list = []
    for seed in (r for r in carried if r in written):
        # depth[reg] = the chain (a list of loop indices) that produced it.
        depth = {seed: []}
        for i, (_, guarded, _, dests, srcs) in enumerate(loop):
            chains = [depth[r] for r in srcs if r in depth]
            if not chains:
                if not guarded:
                    for r in dests:
                        depth.pop(r, None)
                continue
            new = max(chains, key=len) + [i]
            for r in dests:
                if not (guarded and len(depth.get(r, ())) > len(new)):
                    depth[r] = new
        if len(depth.get(seed, ())) > len(best):
            best = depth[seed]
    return [loop[i][2] for i in best]


def _loop_chain(sass: str, kernel: str) -> tuple[int, list]:
    """The loop of ``kernel`` (a substring of its mangled name) in
    ``cuobjdump -sass`` output -- the span of a backward branch that holds
    no EXIT -- whose loop-carried dependence chain is the longest (for the
    encode kernel,
    the chain warp's chunk loop: the producer's and the writer's loops
    carry little more than their counters).  Returns the loop's
    instruction count and the opcodes of that chain."""
    for body in sass.split("Function : ")[1:]:
        if kernel in body.split("\n", 1)[0]:
            break
    else:
        fail(f"no {kernel} in the SASS")
    instrs = _sass_instructions(body)
    back = [(int(at, 16), int(to, 16)) for at, to in re.findall(
        r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+0x([0-9a-f]+)", body)]
    # A loop's span holds no EXIT; a branch back from an out-of-line wait
    # jumps across the kernel's exits and is not a loop.
    exits = [i[0] for i in instrs if i[2] == "EXIT"]
    back = [(at, to) for at, to in back
            if to < at and not any(to <= e <= at for e in exits)]
    if not back:
        fail(f"no loop of {kernel} found in the SASS")
    best = (0, [])
    for at, to in back:
        loop = [i for i in instrs if to <= i[0] <= at]
        chain = _carried_chain(loop)
        if len(chain) > len(best[1]):
            best = (len(loop), chain)
    return best


_WALK_INSTANCE = re.compile(r"(walk_pointer|walk_symbol)_kernelILb([01])ELi"
                            r"(\d+)ELi(\d+)EE")


def _log_walk_registers(report: str) -> None:
    """The walk library's ``-Xptxas -v`` report, one line per kernel and
    slot-table layout: registers a thread (and spill bytes, if any) of each
    (W, block) instance.  The 128-thread column is the default launch
    (``rows_per_block=None``); its own line follows."""
    regs, name, spill = {}, None, 0
    for line in report.splitlines():
        m = _WALK_INSTANCE.search(line)
        if "Compiling entry" in line:
            name = m and (m.group(1), m.group(2) == "1", int(m.group(3)),
                          int(m.group(4)))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = (int(m.group(1)), spill)
    if not regs:
        fail("no walk kernel instance in the ptxas report")
    for kernel in ("walk_pointer", "walk_symbol"):
        for packed in (False, True):
            cells = []
            for ways in (8, 16, 32, 64, 128):
                per = [f"{b}:{r}" + (f"(spill {sp} B)" if sp else "")
                       for (k, pk, w, b), (r, sp) in sorted(regs.items())
                       if (k, pk, w) == (kernel, packed, ways)]
                cells.append(f"W{ways} {' '.join(per)}")
            log(f"[build] {kernel} {'packed' if packed else 'three-table'} "
                f"registers by block threads: {'; '.join(cells)}")
    default = {f"{k} {'packed' if pk else 'three-table'} W{w}": r
               for (k, pk, w, b), (r, _) in sorted(regs.items()) if b == 128}
    log(f"[build] default launch (rows_per_block=None, 128 threads) "
        f"registers a thread: {default}; {len(regs)} walk instances")


def phase_build(libraries) -> tuple[float, float]:
    """Builds every kernel library at once (one nvcc each), loads them and
    returns, from the encode kernel's SASS, the instructions on one step's
    state chain and those its chain warp issues a step."""
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.build) for lib in libraries]:
            fut.result()
    for lib in libraries:
        lib.load()
    log(f"[build] {len(libraries)} x nvcc (in parallel) + load "
        f"{time.perf_counter() - t:.1f} s")
    _log_walk_registers(libraries[0].ptxas_report())
    for lib in libraries[1:]:
        for line in lib.ptxas_report().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("[build] " + line.strip())
    from repro_torch.kernels.build import nvcc
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(libraries[1].path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    n_loop, chain = _loop_chain(sass, ENCODE_SASS_KERNEL)
    step = len(chain) / ENCODE_CHUNK
    log(f"[build] encode_scan_kernel chunk loop (chain warp): {n_loop} SASS "
        f"instructions for {ENCODE_CHUNK} steps, {n_loop / ENCODE_CHUNK:g} a "
        f"step; the state's dependence chain: {len(chain)} instructions, "
        f"{step:g} a step (the bound's model: {ENCODE_STEP_OPS}); the last "
        f"step's: {' '.join(chain[-round(step):])}")
    return step, n_loop / ENCODE_CHUNK


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


def _int16(words, dev, pad=0) -> torch.Tensor:
    """16-bit words as int16 bit patterns on the card, ``pad`` zero words
    appended (a valid walk never reads them)."""
    a = np.concatenate([np.asarray(words, np.uint16), np.zeros(pad, np.uint16)])
    return torch.as_tensor(a.view(np.int16), device=dev)


def phase_kernels(dev, errs) -> None:
    from repro_torch.core.engine import (SPLIT_FIELDS, SYMBOL_SPLIT_FIELDS,
                                         kept_windows_tile, pad_split_arrays)
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl,
                                             words_by_symbol_host)
    from repro_torch.kernels.rans_decode.ops import _luts, packed_lut_ok
    from repro_torch.kernels.rans_decode.rans_decode import (
        walk_decode_pointer, walk_decode_symbol)
    cases, odd_lengths, refills = 0, 0, 0
    for ways in (8, 16, 32, 64, 128):
        for n_bits in (11, 16):
            # Many short splits, then three long ones.
            for n, n_splits in ((40_000, 61), (60_000, 3)):
                syms, model, enc, batch = _content(
                    ways * 100 + n_bits + n_splits, n, ways, n_bits, n_splits)
                S = batch.k.shape[0]
                arrs = pad_split_arrays(batch, S + 5, dev)
                st = dict(n_bits=n_bits, ways=ways, n_steps=batch.n_steps,
                          n_symbols=n)
                run = dict(covered=kept_windows_tile(batch, n))
                if not run["covered"]:
                    fail(f"a plan_splits plan is not covered (W={ways})")
                wbs = words_by_symbol_host(enc.stream, enc.k_of_word, n)
                by = _int16(wbs, dev, (-n) % ways + 3 * ways)
                for packed in sorted({False, packed_lut_ok(model)}):
                    luts = _luts(model, packed, dev)
                    a = (_int16(enc.stream, dev), *luts,
                         *(arrs[f] for f in SPLIT_FIELDS))
                    ref, ref_qf = _walk_batch_impl(*a, **st)
                    if int(ref_qf.min()) != -1:
                        fail("no split read down to word 0")
                    walked = (arrs["q0"] - ref_qf)[:S].max()
                    refills = max(refills, int(walked) // max(ways, 32))
                    for pad in (0, 1, 3):
                        words = _int16(enc.stream, dev, pad)
                        odd_lengths += words.numel() % 8 != 0
                        out, qf = walk_decode_pointer(
                            words, *a[1:], **st, **run)
                        _compare("walk_pointer", out, ref, errs)
                        _compare("walk_pointer", qf, ref_qf, errs)
                    a = (by, *luts, *(arrs[f] for f in SYMBOL_SPLIT_FIELDS))
                    ref = _walk_batch_symbol_impl(*a, **st)
                    _compare("walk_symbol", walk_decode_symbol(*a, **st, **run),
                             ref, errs)
                    _compare("walk_symbol", walk_decode_symbol(*a, **st),
                             ref, errs)
                    try:
                        walk_decode_symbol(by.to(torch.int32), *a[1:], **st)
                    except ValueError:
                        pass
                    else:
                        fail("the symbol kernel took an int32 permutation")
                    cases += 1
                    if not (ref.cpu().numpy() == syms).all():
                        fail(f"plain decode != symbols (W={ways}, n={n_bits})")
    torch.cuda.synchronize()
    if odd_lengths == 0:
        fail("no stream length was off a multiple of 8")
    log(f"[kernels] {cases} content/table/width cases x (pointer on 3 stream "
        f"lengths + symbol with and without padding rows) equal their plain "
        f"versions; {odd_lengths} stream lengths off a multiple of 8, every "
        f"bottom split read word 0, up to {refills} ring chunks a split; "
        f"max |err| {errs}")


def _encode_args(syms, model, dev, head=0, ctx=None, x0=None):
    from repro_torch.core.encode.executors import encode_scan_args
    return encode_scan_args(syms, model.f, model.F, model.params.ways, dev,
                            head, ctx, x0)


def _encode_batch(rows, ways, dev, x0, model=None):
    """The encode-scan wrapper's arguments for B ragged contents: ``rows``
    of ``(head, symbols, ctx)`` numpy arrays laid out by the executor's
    ``scan_grids``; ``x0`` u32[B, W]."""
    from repro_torch.core.encode.executors import scan_grids
    t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int64).astype(np.int32), device=dev)
    adaptive = rows[0][2] is not None
    sym, active, ctx, x0 = scan_grids(
        [(h, t(s), t(c)) for h, s, c in rows], ways, dev, adaptive,
        torch.as_tensor(np.asarray(x0, np.uint32).view(np.int32),
                        device=dev))
    f, F = (torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
            for a in (model.f, model.F))
    return (sym, active, f, F, x0) + ((ctx,) if adaptive else ())


def phase_encode_kernels(dev, errs) -> None:
    from repro_torch.core.adaptive import ContextModel
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.kernels.rans_encode import rans_encode as re_
    rng = np.random.default_rng(7)
    u32 = lambda *shape: rng.integers(  # noqa: E731
        1 << 16, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    expo = lambda n, lam=30.0: np.minimum(  # noqa: E731
        rng.exponential(lam, size=n).astype(np.int64), 255)
    cases = []      # (name, args, n_bits, zero_freq flag of each content)
    for ways in (8, 16, 32, 64, 128):
        for n_bits in (11, 12, 16):
            for n, head in ((5, 0), (3_001, 3_001 % ways),
                            (ways * 40, ways - 1)):
                syms = expo(n)
                model = StaticModel.from_symbols(
                    np.concatenate([syms, np.arange(256)]), 256,
                    RansParams(n_bits=n_bits, ways=ways))
                cases.append((f"W={ways} n={n_bits} N={n} head={head}",
                              _encode_args(syms, model, dev, head, None,
                                           u32(ways)), n_bits, [False]))
    # Group counts around the ring's chunk of ENCODE_CHUNK groups: under
    # one, one, the tail just past one, two and a tail, and past the wrap
    # of the ring's 4 stages.
    m32 = StaticModel.from_symbols(np.concatenate([expo(5_000),
                                                   np.arange(256)]), 256,
                                   RansParams(n_bits=11, ways=32))
    C = ENCODE_CHUNK
    for G in (1, 7, 8, 9, C - 1, C, C + 1, 2 * C + 1, 4 * C + 1):
        cases.append((f"G={G}", _encode_args(expo(G * 32 - 5), m32, dev, 3,
                                             None, u32(32)), 11, [False]))
    # Ragged batches of 5 contents, static and adaptive, at W 8 and 128; a
    # static one whose content 3 opens with a zero-frequency symbol in a
    # way whose state starts at 0 (the compare's edge: it must emit).
    for ways in (8, 128):
        lens = (3_001, 17, ways * 10, 999, 2)
        heads = (0, 5, ways - 1, 0, 1)
        rows = [(h, expo(n, 3.0), None) for h, n in zip(heads, lens)]
        model = StaticModel.from_symbols(
            np.concatenate([r[1] for r in rows]), 256,
            RansParams(n_bits=11, ways=ways))
        rows[3][1][0] = int(np.flatnonzero(model.f == 0)[0])
        x0 = u32(5, ways)
        x0[3, 0] = 0
        cases.append((f"ragged static W={ways}",
                      _encode_batch(rows, ways, dev, x0, model), 11,
                      [False, False, False, True, False]))
        n_ctx = 3
        ctx_of = lambda n: (np.arange(n) % n_ctx).astype(np.int32)  # noqa
        cm = ContextModel.from_scale_table(
            [3.0, 8.0, 20.0], ctx_of(64), 256,
            RansParams(n_bits=11, ways=ways))
        rows = [(h, expo(n), ctx_of(n)) for h, n in zip(heads, lens)]
        cases.append((f"ragged adaptive W={ways}",
                      _encode_batch(rows, ways, dev, u32(5, ways), cm), 11,
                      [False] * 5))
    wide = rng.integers(0, 4096, size=20_000)
    m12 = StaticModel.from_symbols(np.concatenate([wide, np.arange(4096)]),
                                   4096, RansParams(n_bits=12, ways=32))
    cases.append(("4096-symbol alphabet (table in shared memory, > 48 KB)",
                  _encode_args(wide, m12, dev, 7, None, u32(32)), 12,
                  [False]))
    wider = rng.integers(0, 5000, size=20_000)
    m13 = StaticModel.from_symbols(np.concatenate([wider, np.arange(5000)]),
                                   5000, RansParams(n_bits=13, ways=32))
    cases.append(("5000-symbol alphabet (table through __ldg)",
                  _encode_args(wider, m13, dev, 0, None, u32(32)), 13,
                  [False]))
    n = 9_003
    ctx = (np.arange(n) % 4).astype(np.int32)
    cm = ContextModel.from_scale_table([3.0, 8.0, 20.0, 60.0], ctx, 256,
                                       RansParams(n_bits=11, ways=32))
    cases.append(("adaptive", _encode_args(expo(n), cm, dev, ctx=ctx), 11,
                  [False]))
    skew = expo(2_000, 3.0)
    mz = StaticModel.from_symbols(skew, 256, RansParams(n_bits=11, ways=32))
    missing = int(np.flatnonzero(mz.f == 0)[-1])
    skew[777] = missing
    cases.append(("zero frequency", _encode_args(skew, mz, dev), 11, [True]))
    # Symbols outside the alphabet, which the session never passes: the
    # wrapper takes them as f = 0, as the plain version does.
    args = _encode_args(expo(2_000), mz, dev)
    args[0].view(-1)[[5, 900]] = torch.tensor([-2, 300], dtype=torch.int32,
                                              device=dev)
    cases.append(("out-of-alphabet symbols", args, 11, [True]))
    for name, args, n_bits, flagged in cases:
        got = re_.encode_scan(*args, n_bits=n_bits)
        want = re_.encode_scan_plain(*args, n_bits=n_bits)
        for g, w in zip(got, want):
            _compare("encode_scan", g, w, errs)
        if got[4].tolist() != flagged:
            fail(f"encode_scan zero-frequency flags wrong on {name}")
    # The executor's table, passed as the main path passes it, and one built
    # for another n_bits, which must be refused.
    args = _encode_args(expo(3_000), m32, dev)
    table = re_.encoder_table(args[2], args[3], 11)
    for g, w in zip(re_.encode_scan(*args, n_bits=11, table=table),
                    re_.encode_scan_plain(*args, n_bits=11)):
        _compare("encode_scan", g, w, errs)
    try:
        re_.encode_scan(*args, n_bits=11,
                        table=re_.encoder_table(args[2], args[3], 12))
    except ValueError:
        pass
    else:
        fail("encode_scan took a table built for another n_bits")
    torch.cuda.synchronize()
    log(f"[kernels] encode_scan: {len(cases) + 1} cases (W 8..128 x n "
        "11/12/16 x lengths under W and off a multiple of W, lead slots and "
        f"random x0; G 1..{4 * C + 1} around the {C}-group chunk and the "
        "4-stage ring; ragged batches of 5, static and adaptive, W 8 and 128, a "
        "zero-frequency symbol at x0 = 0; 4096- and 5000-symbol alphabets; "
        "adaptive; zero frequency and out-of-alphabet symbols flagged; the "
        "caller's table) equal the plain version; a table for another "
        f"n_bits refused; max |err| {errs['encode_scan']}")


def phase_plan_kernels(dev, errs) -> None:
    from torch_checks import plan_inputs, won_rounds

    from repro_torch.core import heuristic
    from repro_torch.kernels.rans_encode import rans_encode as re_

    def expo(seed, n, lam=40.0):
        rng = np.random.default_rng(seed)
        return np.minimum(rng.exponential(lam, size=n).astype(np.int64), 255)

    # (contents, W, n_splits of each, window): a window-expansion trigger,
    # W 8..128, up to 2176 splits, a window-2 case whose slots are won in
    # later rounds, and a ragged batch of three (one split; no word; slots
    # past a content's M - 1).
    cases = (([expo(2, 4_000, 2.0)], 32, [100], WINDOW),
             ([expo(5, 30_000)], 64, [2_176], WINDOW),
             ([expo(6, 20_011)], 8, [16], WINDOW),
             ([expo(8, 300_000)], 32, [2_176], WINDOW),
             ([expo(9, 12_007)], 128, [8], WINDOW),
             ([expo(3, 200_000, 100.0)], 32, [2_176], 2),
             ([expo(31, 5_000), expo(32, 9), expo(33, 20_011)], 32,
              [1, 7, 40], WINDOW))
    rounds = {}
    for i, (contents, ways, n_splits, window) in enumerate(cases):
        args, yw = plan_inputs(contents, ways, n_splits, dev)
        kw, csum, last, _, n_words, n_symbols, m = args
        st = dict(window=window, n_slots=max(n_splits) - 1 + 5)
        got = re_.plan_splits(*args, **st)
        for g, w in zip(got, re_.plan_splits_plain(*args, **st)):
            _compare("plan_splits", g, w, errs)
        if i == 0 and int(got[0].sum()) != 97:
            fail("the window-expansion trigger no longer stops at slot 97, "
                 "which runs every round and finds no candidate")
        cover = re_.plan_cover(kw, last, n_words)
        _compare("plan_splits", cover,
                 re_.plan_cover_plain(kw, last, n_words), errs)
        won = won_rounds(*(t.cpu() for t in (got[1], got[0], cover, csum,
                                             n_words, n_symbols, m)),
                         window=window)
        for r in won[won >= 0].tolist():
            rounds[r] = rounds.get(r, 0) + 1
        for b, (NW, N, M) in enumerate(zip(n_words.tolist(),
                                           n_symbols.tolist(), m.tolist())):
            index = heuristic.EmissionIndex(
                kw[b, :NW].cpu().numpy(),
                yw[b, :NW].cpu().numpy().view(np.uint32), ways)
            offsets, ks, ys_h = heuristic.plan_split_offsets(
                index, N, M, window=window)
            found = got[0][b].cpu().numpy()
            if not (found.sum() == len(offsets)
                    and np.array_equal(got[1][b].cpu().numpy()[found],
                                       offsets)
                    and np.array_equal(got[2][b].cpu().numpy()[found], ks)
                    and np.array_equal(
                        got[3][b].cpu().numpy()[found].view(np.uint32),
                        ys_h)):
                fail(f"plan_splits differs from heuristic.plan_split_offsets "
                     f"(content {b} of {len(contents)}, W={ways}, "
                     f"{M} splits, window {window})")
    torch.cuda.synchronize()
    if not any(r > 0 for r in rounds):
        fail("no slot of the planner cases was won after its first round")
    log(f"[kernels] plan_splits: {len(cases)} cases (a window-expansion "
        "trigger: seed 2, lambda 2, 4000 symbols, 100 splits; W 8..128; up "
        "to 2176 splits; window 2; a ragged batch of 3 with one split, no "
        "word and slots past a content's M - 1) equal the plain version and "
        "heuristic.plan_split_offsets, and the cover kernel plan_cover_plain "
        f"on every word; slots won by round {dict(sorted(rounds.items()))}; "
        f"max |err| {errs['plan_splits']}")


def _hold_session_walk(sess, batch, stream, n_symbols, want, errs) -> str:
    """The card session's executor call for one request held against the
    plain walk of its layout (``torch_checks.session_walk``) and against
    the symbols it must decode; returns the layout."""
    from torch_checks import session_walk
    layout, pairs = session_walk(sess, batch, stream, n_symbols)
    for got, ref in pairs:
        _compare("walk_" + layout, got, ref, errs)
    if not np.array_equal(pairs[0][0].cpu().numpy(), want):
        fail(f"walk_{layout} through the session != the symbols")
    return layout


def phase_walk_coverage(dev, errs) -> None:
    """Both walks through a card session at n_bits 8 and 14, on a
    4096-symbol alphabet, through ``decode_conventional`` and on the
    golden wire vectors, each against its plain version."""
    from repro_torch.core import container, conventional, recoil
    from repro_torch.core.engine import DecoderSession, with_symbol_layout
    from repro_torch.core.rans import RansParams, StaticModel
    from repro_torch.core.vectorized import WalkBatch, encode_interleaved_fast
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.kernels.rans_decode.ops import packed_lut_ok
    launches = rd.walk_decode_pointer.launches + rd.walk_decode_symbol.launches
    cases = 0

    def both_layouts(syms, model, n_splits):
        nonlocal cases
        enc = encode_interleaved_fast(syms, model)
        batch = WalkBatch.from_splits(recoil.build_split_states(
            recoil.plan_splits(enc, n_splits), enc.final_states),
            model.params.ways)
        for packed in sorted({False, packed_lut_ok(model)}):
            sess = DecoderSession(model, device=dev, packed_lut=packed)
            ds = sess.upload_stream(enc.stream)
            layouts = [_hold_session_walk(sess, batch, ds, len(syms), syms,
                                          errs)]
            ds = with_symbol_layout(ds, enc.k_of_word, len(syms))
            layouts.append(_hold_session_walk(sess, batch, ds, len(syms),
                                              syms, errs))
            if layouts != ["pointer", "symbol"]:
                fail(f"walk coverage ran on {layouts}")
            cases += 1

    for n_bits in (8, 14):
        for ways in (8, 32, 128):
            rng = np.random.default_rng(ways * 10 + n_bits)
            syms = np.minimum(rng.exponential(40.0, size=40_000).astype(
                np.int64), 255)
            both_layouts(syms, StaticModel.from_symbols(
                np.concatenate([syms, np.arange(256)]), 256,
                RansParams(n_bits=n_bits, ways=ways)), 37)
    rng = np.random.default_rng(5)
    wide = rng.integers(0, 4096, size=40_000)
    m4096 = StaticModel.from_symbols(np.concatenate([wide, np.arange(4096)]),
                                     4096, RansParams(n_bits=14, ways=32))
    if packed_lut_ok(m4096):
        fail("a 4096-symbol model took the packed slot table")
    both_layouts(wide, m4096, 24)
    # The conventional adapter (a pointer walk: no emission log).
    syms, model, _, _ = _content(17, 60_000, 32, 11, 1)
    conv = conventional.encode_conventional(syms, model, 9)
    sess = DecoderSession(model, device=dev)
    states, words, out_bases = conventional.to_split_states(conv)
    _hold_session_walk(sess, WalkBatch.from_splits(states, 32, out_bases),
                       words, conv.n_symbols, syms, errs)
    if not np.array_equal(sess.decode_conventional(conv).cpu().numpy(),
                          syms):
        fail("decode_conventional on the card != the symbols")
    # The golden wire vectors, both layouts.
    golden = os.path.join(TESTS, "golden")
    names = sorted(f[:-4] for f in os.listdir(golden) if f.endswith(".bin"))
    if len(names) < 4:
        fail(f"golden vectors missing from {golden}")
    for name in names:
        with open(os.path.join(golden, f"{name}.bin"), "rb") as f:
            buf = f.read()
        npz = np.load(os.path.join(golden, f"{name}.npz"))
        parsed = container.parse(buf, RansParams(n_bits=int(npz["n_bits"]),
                                                 ways=int(npz["ways"])))
        syms = npz["symbols"]
        batch = WalkBatch.from_splits(
            recoil.build_split_states(parsed.plan, parsed.final_states),
            parsed.plan.ways)
        sess = DecoderSession(parsed.model, device=dev)
        ds = sess.upload_stream(parsed.stream)
        for layout in ("pointer", "symbol"):
            if layout == "symbol":
                ds = with_symbol_layout(ds, npz["k_of_word"], len(syms))
            if _hold_session_walk(sess, batch, ds, len(syms), syms,
                                  errs) != layout:
                fail(f"golden {name} ran on the wrong layout")
            out = sess.decode(parsed.plan, ds, parsed.final_states)
            if not np.array_equal(out.cpu().numpy(), syms):
                fail(f"golden {name} ({layout}) != its frozen symbols")
    torch.cuda.synchronize()
    ran = rd.walk_decode_pointer.launches + rd.walk_decode_symbol.launches \
        - launches
    # Each case holds both layouts; the conventional adapter one call and
    # one decode; each golden vector two of each.
    if torch.device(dev).type == "cuda" and ran != 2 * cases + 2 + 4 * len(
            names):
        fail(f"walk coverage made {ran} kernel launches")
    log(f"[kernels] walk coverage: {cases} model/slot-table cases (n_bits 8 "
        "and 14 at W 8, 32, 128; a 4096-symbol alphabet at n 14, three "
        "tables) on both layouts, decode_conventional (pointer), and "
        f"{len(names)} golden vectors ({', '.join(names)}) on both layouts: "
        f"{ran} kernel launches equal their plain walks and the symbols; "
        f"max |err| {{'walk_pointer': {errs['walk_pointer']}, "
        f"'walk_symbol': {errs['walk_symbol']}}}")


def _windows_tile(plan) -> bool:
    """Independent check of ``plan.covered``: the rows' kept windows, empty
    ones aside, laid end to end cover [0, n_symbols)."""
    split = dict(zip(("g_hi", "start", "stop", "keep_lo", "keep_hi",
                      "out_base"), plan.args[8:]))
    lo = (split["out_base"] + split["keep_lo"]).cpu().numpy()
    hi = (split["out_base"] + split["keep_hi"]).cpu().numpy()
    spans = sorted((a, b) for a, b in zip(lo.tolist(), hi.tolist()) if b > a)
    at = 0
    for a, b in spans:
        if a != at:
            return False
        at = b
    return at == plan.n_symbols


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


def _same_plan(got, want) -> bool:
    return (got.n_symbols, got.n_words, len(got.points)) == \
        (want.n_symbols, want.n_words, len(want.points)) and all(
            a.offset == b.offset and np.array_equal(a.k, b.k)
            and np.array_equal(a.y, b.y)
            for a, b in zip(got.points, want.points))


def _host_words(t, n) -> np.ndarray:
    return t[:n].cpu().numpy().view(np.uint16)


def _same_ingest(a, b) -> bool:
    """Two contents (ingest results or service records) are the same:
    stream words, final states, split points and permutation."""
    return (a.stream.n_words == b.stream.n_words
            and torch.equal(a.stream.words, b.stream.words)
            and torch.equal(a.stream.by_symbol, b.stream.by_symbol)
            and np.array_equal(a.final_states, b.final_states)
            and _same_plan(a.plan, b.plan))


def _suffix_points(enc, n0: int, d: int, n_splits: int, ways: int):
    """The reference's extend points from the host encoding of the whole
    content: the suffix's emissions are the whole stream's at symbols
    >= n0 (each way's chain is the same), planned by Def 4.1 in the suffix
    grid's coordinates (origin (n0 // W) * W, offsets after the old words)
    and moved back."""
    from repro_torch.core import heuristic
    origin = n0 - n0 % ways
    old_n = int(np.searchsorted(enc.k_of_word, n0))
    index = heuristic.EmissionIndex(enc.k_of_word[old_n:] - origin,
                                    enc.y_of_word[old_n:], ways)
    offsets, ks, ys = heuristic.plan_split_offsets(
        index, n0 % ways + d, n_splits, window=WINDOW)
    return [(int(q) + old_n, k + origin, y) for q, k, y in zip(offsets, ks,
                                                                 ys)]


def phase_main(dev, rd, re_):
    from repro_torch.core import container, recoil
    from repro_torch.core.encode import EncoderSession
    from repro_torch.core.vectorized import (encode_interleaved_fast,
                                             words_by_symbol_host)
    from repro_torch.runtime.faultinject import FaultInjector
    from repro_torch.runtime.serve import DecodeService
    assets, model = _assets()
    # The host reference: the port's host encoder and numpy planner.
    t = time.perf_counter()
    enc = {k: encode_interleaved_fast(v, model) for k, v in assets.items()}
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    plans = {k: recoil.plan_splits(e, PLAN_THREADS) for k, e in enc.items()}
    t_plan = time.perf_counter() - t
    log(f"[main] host reference: encode {t_enc:.2f} s, plan {t_plan:.2f} s "
        f"for 2 x 10 MB; words {enc['expo'].n_words} + "
        f"{enc['zipf'].n_words}; {PLAN_THREADS}-thread plans")
    want = {k: torch.as_tensor(v.astype(np.int32), device=dev)
            for k, v in assets.items()}
    raw = {k: v.astype(np.uint8) for k, v in assets.items()}   # the files

    rd.reset_counts()
    re_.reset_counts()
    faults = FaultInjector()       # armed only by the fault checks below
    svc = DecodeService(model, device=dev, faults=faults)
    svc.ingest("expo", raw["expo"], PLAN_THREADS)
    coder = EncoderSession(model, device=dev)
    zres = coder.ingest(raw["zipf"], PLAN_THREADS)
    # The emission logs, from the card, for the comparison with the host.
    logs = {k: coder.encode(raw[k]) for k in assets}
    wire = container.pack_recoil(logs["zipf"], model, zres.plan)
    parsed = container.parse(wire, model.params)
    svc.register("zipf", parsed.plan, parsed.stream, parsed.final_states,
                 model=parsed.model)
    ingested = {"expo": svc.content("expo"), "zipf": zres}
    for k in assets:
        e, got = enc[k], ingested[k]
        ok = (np.array_equal(_host_words(got.stream.words, e.n_words),
                             e.stream)
              and got.stream.n_words == e.n_words
              and np.array_equal(got.final_states, e.final_states)
              and _same_plan(got.plan, plans[k])
              and np.array_equal(
                  _host_words(got.stream.by_symbol, e.n_symbols),
                  words_by_symbol_host(e.stream, e.k_of_word,
                                       e.n_symbols).astype(np.uint16))
              and all(np.array_equal(getattr(logs[k], f), getattr(e, f))
                      for f in ("stream", "final_states", "k_of_word",
                                "y_of_word")))
        if not ok:
            fail(f"{k}: the card's ingest differs from the host reference")
    if not np.array_equal(parsed.stream, enc["zipf"].stream):
        fail("zipf: the wire container's stream differs from the host's")
    log(f"[main] both assets ingested on the card equal the host reference: "
        f"stream words, k_of_word, y_of_word, final states, "
        f"{len(plans['expo'].points)} + {len(plans['zipf'].points)} split "
        f"points, permutation; zipf container {len(wire)} B")
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

    # Coverage: every single-content plan skips the fill; the fused plan's
    # flag is what an independent check of its windows says.
    singles = [svc.prepare_request(n, th) for th in THREADS for n in assets]
    if not all(p.covered and _windows_tile(p) for p in singles):
        fail("a single-content plan is not covered")
    fused = [p for p, _, _ in svc._fused_plans.values()]
    if len(fused) != 1 or fused[0].covered != _windows_tile(fused[0]):
        fail("the fused plan's coverage differs from its windows")
    fills = rd.walk_decode_pointer.fills + rd.walk_decode_symbol.fills
    if fills != sum(not p.covered for p in fused):
        fail(f"{fills} output fills on the main path, expected none for "
             "covered plans")
    log(f"[main] {len(singles)} single-content plans covered, fused plan "
        f"covered={fused[0].covered} ({fused[0].args[4].shape[0]} rows): "
        "no output fill on the main path")
    _check_streams(svc, assets, want, enc, dev, rd)
    _check_wire_prefixes(svc, want, logs["zipf"], zres.plan, model, dev)
    _check_groups_and_faults(svc, reqs, want, faults)

    # extend: the first 9 MB, then the last 1 MB.
    expo = raw["expo"]
    head_plan = svc.ingest("grown", expo[:EXTEND_AT], PLAN_THREADS)
    grown = svc.extend("grown", expo[EXTEND_AT:])
    full = coder.ingest(expo, PLAN_THREADS)
    g = svc.content("grown")
    m_suffix = 1 + -(-(head_plan.n_threads - 1) * (len(expo) - EXTEND_AT)
                     // EXTEND_AT)
    points = [(p.offset, p.k, p.y) for p in head_plan.points] + \
        _suffix_points(enc["expo"], EXTEND_AT, len(expo) - EXTEND_AT,
                       m_suffix, WAYS)
    if not (g.stream.n_words == full.n_words
            and torch.equal(g.stream.words, full.stream.words)
            and torch.equal(g.stream.by_symbol, full.stream.by_symbol)
            and np.array_equal(g.final_states, full.final_states)
            and len(grown.points) == len(points)
            and all(p.offset == q and np.array_equal(p.k, k)
                    and np.array_equal(p.y, y)
                    for p, (q, k, y) in zip(grown.points, points))):
        fail("extend differs from the full ingest or the reference's points")
    for th in THREADS:
        if not torch.equal(svc.decode("grown", th), want["expo"]):
            fail(f"extended content at {th} threads != input symbols")
    log(f"[main] extend 9 MB + 1 MB = full ingest (words, final states, "
        f"permutation); {len(grown.points)} points = the 9 MB plan's "
        f"{len(head_plan.points)} + the suffix's Def-4.1 points; decodes "
        "bit-exactly at 16, 128, 2176 threads")

    # ingest_batch: three contents in one pipeline call.
    parts = {"b0": raw["expo"][:MB], "b1": raw["zipf"][:2 * MB],
             "b2": raw["expo"][3 * MB:4 * MB + 777]}
    svc.ingest_batch(parts, 64)
    for name, part in parts.items():
        single = coder.ingest(part, 64)
        if not _same_ingest(svc.content(name), single):
            fail(f"ingest_batch {name} differs from its single ingest")
        if not torch.equal(svc.decode(name, 64).cpu(),
                           torch.as_tensor(part.astype(np.int32))):
            fail(f"batch-ingested {name} != input symbols")
    log("[main] ingest_batch of 3 contents = 3 single ingests; decodes "
        "bit-exactly")
    stats = svc.stats.snapshot()
    if stats["fused_dispatches"] != 2 or stats["pointer_plans"] < 4:
        fail("the mixed group did not fuse into one pointer-layout dispatch "
             "through submit/flush and one through dispatch_group")
    if (stats["ingests"], stats["extends"]) != (5, 1):
        fail(f"service counted {stats['ingests']} ingests and "
             f"{stats['extends']} extends, expected 5 and 1")
    _check_pipeline(svc, want, raw, model, faults, head_plan, full, points)
    torch.cuda.synchronize()

    launches = {"walk_pointer": rd.walk_decode_pointer.launches,
                "walk_symbol": rd.walk_decode_symbol.launches,
                "encode_scan": re_.encode_scan.launches,
                "plan_splits": re_.plan_splits.launches}
    plain = (rd.walk_decode_pointer.plain_calls
             + rd.walk_decode_symbol.plain_calls
             + re_.encode_scan.plain_calls + re_.plan_splits.plain_calls)
    fills = rd.walk_decode_pointer.fills + rd.walk_decode_symbol.fills
    log(f"[main] layouts {layouts}; launches {launches}; plain versions "
        f"{plain}; output fills {fills}; service {svc.stats.snapshot()}")
    if min(launches.values()) == 0 or plain != 0:
        fail("the main path did not run on all four kernels alone")
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


def _expo(seed: int) -> np.ndarray:
    """A 10 MB asset of expo's distribution (rand_exponential(100)) from
    another seed, as the file's bytes."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.exponential(scale=2550.0 / 100, size=10 * MB),
                      255).astype(np.uint8)


def _metric_values(svc, prefix: str) -> dict:
    """``metrics_text()``'s samples whose name starts with ``prefix``."""
    return {k: float(v) for k, v in (
        line.rsplit(" ", 1) for line in svc.metrics_text().splitlines()
        if line.startswith(prefix))}


def _check_pipeline(svc, want, raw, model, faults, head_plan, full,
                    points) -> None:
    """The serving pipeline at full width on phase 4's service: the broker
    (``start_pipeline``, max_batch 8) warmed over both assets at THREADS;
    64 requests mixed over both names, the three thread counts and the
    three deadline classes, each equal to its asset, resolving no launcher,
    while the ingest worker takes the first 9 MB of expo; then an extend
    by the last 1 MB with decodes of that content in flight (each equal to
    the old content or the new, never a mix) and a third 10 MB asset, both
    equal to the host reference; decodes right after each ingest ticket;
    streams of 8 chunks through the broker; speculation ahead of a request;
    the supervisor, retry and cancel paths; the counters' identity and
    ``metrics_text()``.  Reads only the broker's and tickets' public
    surface."""
    from repro_torch.core import recoil
    from repro_torch.core.vectorized import (encode_interleaved_fast,
                                             words_by_symbol_host)
    from repro_torch.runtime.faultinject import FaultInjected
    from repro_torch.runtime.pipeline import ControllerConfig, TicketCancelled
    names = ["expo", "zipf"]
    wait = 120.0                          # every result() has a timeout
    b = svc.start_pipeline(config=ControllerConfig(max_batch=8))
    with _TimeLaunches(svc.session) as warm_launches:
        t = time.perf_counter()
        b.warm(names, THREADS)
        # warm() enumerates the uniform groups of its first name only, as
        # the reference's does; a partial flush of a lane holding only zipf
        # pads to a uniform zipf group, so zipf's uniform groups are warmed
        # too.
        b.warm(["zipf"], THREADS)
        warm_wall = (time.perf_counter() - t) * 1e3
    compiles = svc.stats.compiles

    rng = np.random.default_rng(7)
    head = b.submit_ingest("b_grown", raw["expo"][:EXTEND_AT], PLAN_THREADS)
    classes = ("interactive", "standard", "bulk")
    traffic = [(names[rng.integers(2)], THREADS[rng.integers(3)])
               for _ in range(64)]
    tickets = [svc.submit(n, th, deadline=classes[i % 3])
               for i, (n, th) in enumerate(traffic)]
    for (name, th), t in zip(traffic, tickets):
        if not torch.equal(t.result(timeout=wait), want[name]):
            fail(f"broker {name} at {th} threads != input symbols")
    b.drain(timeout=wait)
    if svc.stats.compiles != compiles:
        fail(f"broker traffic after warm resolved "
             f"{svc.stats.compiles - compiles} launchers")
    if not _same_plan(head.result(timeout=wait), head_plan):
        fail("the broker's 9 MB ingest differs from the service's")
    old, new = want["expo"][:EXTEND_AT], want["expo"]
    if not torch.equal(svc.submit("b_grown", PLAN_THREADS).result(
            timeout=wait), old):
        fail("a decode after the 9 MB ingest ticket != its symbols")
    snap = b.snapshot()
    log(f"[main] pipeline: 64 broker requests (both assets, {THREADS} "
        f"threads, 3 deadline classes) equal their assets; 0 launchers "
        f"resolved after warm; 9 MB ingest by the ingest worker = the "
        f"service's plan; groups {snap['dispatch_groups']}, deadline "
        f"{snap['deadline']}; warm(): {len(warm_launches.ms)} groups, "
        f"wall {warm_wall:.4f} ms, device {sum(warm_launches.ms):.4f} ms")

    # The extend with decodes of its content in flight, and a third asset.
    expo2 = _expo(101)
    ext = b.submit_extend("b_grown", raw["expo"][EXTEND_AT:])
    racing = [(th, svc.submit("b_grown", th)) for th in THREADS
              for _ in range(4)]
    fresh = b.submit_ingest("expo2", expo2, PLAN_THREADS)
    seen = {"old": 0, "new": 0}
    for th, t in racing:
        out = t.result(timeout=wait)
        if torch.equal(out, new):
            seen["new"] += 1
        elif torch.equal(out, old):
            seen["old"] += 1
        else:
            fail(f"a decode at {th} threads during the extend is neither "
                 "the old content nor the new")
    grown = ext.result(timeout=wait)
    g = svc.content("b_grown")
    if not (g.stream.n_words == full.n_words
            and torch.equal(g.stream.words, full.stream.words)
            and torch.equal(g.stream.by_symbol, full.stream.by_symbol)
            and np.array_equal(g.final_states, full.final_states)
            and len(grown.points) == len(points)
            and all(p.offset == q and np.array_equal(p.k, k)
                    and np.array_equal(p.y, y)
                    for p, (q, k, y) in zip(grown.points, points))):
        fail("the broker's extend differs from the full ingest or the "
             "reference's points")
    for th in THREADS:
        if not torch.equal(svc.submit("b_grown", th).result(timeout=wait),
                           new):
            fail(f"a decode after the extend ticket at {th} threads != "
                 "its symbols")
    fresh_plan = fresh.result(timeout=wait)
    e2 = encode_interleaved_fast(expo2.astype(np.int64), model)
    c2 = svc.content("expo2")
    if not (c2.stream.n_words == e2.n_words
            and np.array_equal(_host_words(c2.stream.words, e2.n_words),
                               e2.stream)
            and np.array_equal(c2.final_states, e2.final_states)
            and _same_plan(fresh_plan, recoil.plan_splits(e2, PLAN_THREADS))
            and np.array_equal(
                _host_words(c2.stream.by_symbol, e2.n_symbols),
                words_by_symbol_host(e2.stream, e2.k_of_word,
                                     e2.n_symbols).astype(np.uint16))):
        fail("the broker's ingest of a third asset differs from the host "
             "reference")
    want2 = torch.as_tensor(expo2.astype(np.int32), device=new.device)
    for th in THREADS:
        if not torch.equal(svc.submit("expo2", th).result(timeout=wait),
                           want2):
            fail(f"a decode after the third asset's ingest ticket at {th} "
                 "threads != its symbols")
    log(f"[main] pipeline: extend 9 MB + 1 MB by the ingest worker = the "
        f"full ingest and the reference's points; {len(racing)} decodes in "
        f"flight during it: {seen['old']} old, {seen['new']} new, none "
        f"torn; a third 10 MB asset (seed 101) = the host reference (words, "
        f"final states, {len(fresh_plan.points)} points, permutation); "
        f"decodes after each ticket exact")

    # Streams through the broker's decode worker.
    for name in names:
        for th in STREAM_THREADS:
            st = svc.submit_stream(name, th, STREAM_CHUNKS)
            for i in range(STREAM_CHUNKS):
                got = st.synchronize(i, timeout=wait)
                spec = st.specs[i]
                if not torch.equal(
                        got, want[name][spec.base:spec.base + spec.length]):
                    fail(f"broker stream {name} at {th} threads: chunk {i} "
                         "!= its symbols")

    # Speculation: a pair declared hot is derived and its launchers
    # resolved ahead of its first request, which is then a memo hit.  The
    # ingest worker's idle gaps may run some or all of the units before
    # speculate() does, so the units are the predictor's own counts.
    pred0 = b.snapshot()["predictive"]
    b.anticipate("expo", 512, weight=8.0)
    units = b.speculate()
    pred1 = b.snapshot()["predictive"]
    prethins = pred1["prethins"] - pred0["prethins"]
    probes = pred1["warm_probes"] - pred0["warm_probes"]
    st0, reg0 = svc.stats, b.registry.snapshot()
    if not torch.equal(svc.submit("expo", 512).result(timeout=wait),
                       want["expo"]):
        fail("the speculated request != its symbols")
    st1 = svc.stats
    b.registry.container_for_threads("expo", 512)
    if (prethins == 0 or probes == 0 or st1.compiles != st0.compiles
            or st1.plan_misses != st0.plan_misses
            or st1.plan_hits != st0.plan_hits + 1
            or b.registry.snapshot()["speculative_hits"]
            <= reg0["speculative_hits"]):
        fail(f"speculation ({prethins} prethins, {probes} warm probes) did "
             "not make the first request a memo hit that resolves no "
             "launcher")

    # Faults: a worker crash, a transient execute fault, a cancel.
    fired = sum(faults.fires.values())
    faults.arm("broker.decode_worker")
    try:
        svc.submit("expo", 16).result(timeout=wait)
    except FaultInjected:
        pass
    else:
        fail("the broker.decode_worker fault did not reach its ticket")
    b.drain(timeout=wait)
    if b.snapshot()["worker_restarts"] != 1 or not torch.equal(
            svc.submit("expo", 16).result(timeout=wait), want["expo"]):
        fail("the supervisor did not restart the decode worker")
    faults.arm("service.execute", times=1)
    if not torch.equal(svc.submit("zipf", 128, retries=2).result(
            timeout=wait), want["zipf"]):
        fail("the retried request != its symbols")
    faults.arm("broker.decode_worker", mode="delay", delay_s=0.5)
    busy = svc.submit("expo", 128)
    deadline = time.perf_counter() + wait
    while b.snapshot()["queue_depth"] and time.perf_counter() < deadline:
        time.sleep(0.001)                 # the worker popped it, and waits
    queued = svc.submit("expo", 128)
    if not queued.cancel():
        fail("a queued request could not be cancelled")
    try:
        queued.result(timeout=wait)
    except TicketCancelled:
        pass
    else:
        fail("a cancelled request did not raise TicketCancelled")
    if not torch.equal(busy.result(timeout=wait), want["expo"]):
        fail("the request ahead of the cancelled one != its symbols")
    b.drain(timeout=wait)
    snap = b.snapshot()
    shown = _metric_values(svc, "recoil_broker_")
    log(f"[main] pipeline: broker streams of {STREAM_CHUNKS} chunks at "
        f"{STREAM_THREADS} threads equal their slices; speculation ran "
        f"{prethins} prethins and {probes} warm probes ({units} units in "
        f"speculate(), the rest in idle gaps), the first request hit the "
        f"memo and resolved 0 launchers; faults fired {sum(faults.fires.values()) - fired}: "
        f"worker_restarts {snap['worker_restarts']}, retries "
        f"{snap['retries']}, dispatch_errors {snap['dispatch_errors']}, "
        f"cancelled {snap['cancelled']}; submitted {snap['submitted']} = "
        f"completed {snap['completed']} + cancelled {snap['cancelled']}")
    if (snap["submitted"] != snap["completed"] + snap["cancelled"]
            or snap["dispatch_errors"] != 1 or snap["cancelled"] != 1
            or shown.get("recoil_broker_retries_total", 0) < 1):
        fail(f"broker counters {snap}")
    if not all(shown.get(f"recoil_broker_{k}_total", 0) > 0 for k in (
            "submitted", "completed", "dispatch_groups", "ingest_dispatches",
            "extend_events", "stream_dispatches", "worker_restarts")):
        fail(f"metrics_text() lacks broker counts: {shown}")
    svc.stop_pipeline()
    if svc.broker is not None:
        fail("stop_pipeline() left a broker attached")


def _check_streams(svc, assets, want, enc, dev, rd) -> None:
    """Streaming on both assets at every thread count and chunk count: each
    chunk of ``decode_chunks`` and of ``submit_stream`` (read with
    ``synchronize``) equals its slice of the symbols, the chunks concatenate
    to ``decode``, the specs tile the asset with ``words_end`` rising to the
    stream's length, every chunk plan is covered; then a warm round resolves
    no launcher and hits the plan memo once per stream."""
    fills = rd.walk_decode_pointer.fills + rd.walk_decode_symbol.fills
    chunks = 0
    for name in assets:
        n, n_words = len(assets[name]), enc[name].n_words
        for th in THREADS:
            whole = svc.decode(name, th)
            for nc in CHUNK_COUNTS:
                parts = svc.decode_chunks(name, th, nc)
                ticket = svc.submit_stream(name, th, nc)
                specs = ticket.specs
                bases = [s.base for s in specs]
                ends = [s.words_end for s in specs]
                if len(parts) != nc or ticket.n_chunks != nc or \
                        sum(s.length for s in specs) != n or \
                        bases != [sum(s.length for s in specs[:i])
                                  for i in range(nc)] or \
                        ends != sorted(ends) or ends[-1] != n_words:
                    fail(f"{name} at {th} threads in {nc} chunks: specs do "
                         f"not tile the asset (ends {ends})")
                for i, spec in enumerate(specs):
                    part = want[name][spec.base:spec.base + spec.length]
                    if not (torch.equal(parts[i], part) and
                            torch.equal(ticket.synchronize(i), part)):
                        fail(f"{name} at {th} threads: chunk {i} of {nc} != "
                             "its symbols")
                if not (torch.equal(torch.cat(parts), whole)
                        and torch.equal(ticket.result(), whole)):
                    fail(f"{name} at {th} threads: {nc} chunks != decode")
                plans = svc._chunk_plans[(name, th, nc)]
                if not all(p.covered and _windows_tile(p) for p, _ in plans):
                    fail(f"{name} at {th} threads: a chunk plan of {nc} is "
                         "not covered")
                chunks += 2 * nc
    if rd.walk_decode_pointer.fills + rd.walk_decode_symbol.fills != fills:
        fail("a chunk launch filled its output")
    st = svc.stats
    compiles, hits = st.compiles, st.plan_hits
    warm = 0
    for name in assets:
        for th in THREADS:
            for nc in CHUNK_COUNTS:
                svc.submit_stream(name, th, nc).synchronize(nc - 1)
                warm += 1
    st = svc.stats
    if st.compiles != compiles or st.plan_hits != hits + warm:
        fail(f"a warm stream resolved {st.compiles - compiles} launchers "
             f"and hit the plan memo {st.plan_hits - hits} times, expected 0 "
             f"and {warm}")
    log(f"[main] streams: {chunks} chunk launches at {THREADS} threads in "
        f"{CHUNK_COUNTS} chunks equal their symbols and concatenate to "
        f"decode; specs tile, words_end rises to n_words; every chunk plan "
        f"covered; a warm round of {warm} streams resolved 0 launchers "
        f"({warm} plan-memo hits)")


def _check_wire_prefixes(svc, want, zenc, zplan, model, dev) -> None:
    """zipf re-packed as an 8-chunk wire container: its directory equals the
    serving chunks' prefixes, and each chunk decodes exactly from a stream
    on the card holding only its ``words_end`` words."""
    from repro_torch.core import container, recoil
    from repro_torch.core.engine import DeviceStream, chunk_walk_batch
    from repro_torch.core.vectorized import WalkBatch
    buf = container.pack_recoil_chunked(zenc, model, zplan, STREAM_CHUNKS)
    parsed = container.parse(buf, model.params)
    batch = WalkBatch.from_splits(
        recoil.build_split_states(parsed.plan, parsed.final_states), WAYS)
    specs = chunk_walk_batch(batch, parsed.n_symbols, STREAM_CHUNKS)
    ends = parsed.chunks.words_end.tolist()
    if [s.words_end for s in specs] != ends:
        fail("the chunked container's directory differs from the chunk specs")
    for spec, n in zip(specs, ends):
        host = np.ascontiguousarray(parsed.stream[:n], np.uint16)
        ds = DeviceStream(words=torch.as_tensor(host.view(np.int16),
                                                device=dev),
                          host=host, n_words=n, bucket=n)
        plan = svc.session.prepare(spec.batch, ds, spec.length)
        if plan.layout != "pointer" or not plan.covered:
            fail(f"the prefix plan of {n} words is not a covered pointer walk")
        if not torch.equal(svc.session.execute(plan),
                           want["zipf"][spec.base:spec.base + spec.length]):
            fail(f"the chunk at {spec.base} != its symbols from a stream of "
                 f"its {n}-word prefix")
    log(f"[main] zipf as an {STREAM_CHUNKS}-chunk wire container "
        f"({len(buf)} B): each chunk decodes from a stream on the card of "
        f"only its words_end words {ends} "
        f"({sum(n % 8 != 0 for n in ends)} not a multiple of 8)")


def _check_groups_and_faults(svc, reqs, want, faults) -> None:
    """``dispatch_group`` of phase 4's mixed group equals ``submit``/
    ``flush`` and reuses its fused plan; ``prepare_group`` counts no
    dispatch; a corruption armed at ``service.register`` is rejected for a
    resident stream; a ``service.dispatch_stream`` fault reaches the
    ticket's first chunk; ``metrics_text()`` shows stream requests and the
    profiler runs of both sessions."""
    from repro_torch.runtime.faultinject import FaultInjected, drop_last_word
    from repro_torch.runtime.serve import DecodeTicket, StreamTicket
    fused = svc.stats.fused_dispatches
    tickets = [DecodeTicket(svc) for _ in reqs]
    svc.dispatch_group(reqs, tickets)
    for (name, th), tk in zip(reqs, tickets):
        if not torch.equal(tk.result(), want[name]):
            fail(f"dispatch_group {name} at {th} threads != input symbols")
    plan = svc.prepare_group(reqs)
    memo = [p for p, _, _ in svc._fused_plans.values()]
    if svc.stats.fused_dispatches != fused + 1 or memo != [plan]:
        fail("dispatch_group did not reuse the fused plan, or prepare_group "
             "counted a dispatch")

    c, gen = svc.content("expo"), svc.generation("expo")
    faults.arm("service.register", mode="corrupt", mutate=drop_last_word)
    try:
        svc.register("expo", c.plan, c.stream, c.final_states)
    except ValueError as e:
        rejected = str(e)
    else:
        fail("register accepted a corrupted resident stream")
    if svc.generation("expo") != gen or svc.content("expo") is not c:
        fail("the rejected registration replaced the content")
    faults.arm("service.dispatch_stream")
    ticket = StreamTicket(svc.stream_chunk_count("expo", 16, STREAM_CHUNKS))
    for call in (lambda: svc.dispatch_stream("expo", 16, STREAM_CHUNKS,
                                             ticket),
                 lambda: ticket.chunk(0, timeout=60)):
        try:
            call()
        except FaultInjected:
            continue
        fail("the dispatch_stream fault did not reach the ticket")
    if faults.fires != {"service.register": 1, "service.dispatch_stream": 1}:
        fail(f"fault firings {faults.fires}")

    values = dict(line.rsplit(" ", 1)
                  for line in svc.metrics_text().splitlines()
                  if not line.startswith("#"))
    shown = {k: float(values.get(k, 0)) for k in (
        "recoil_service_stream_requests_total",
        'recoil_profiler_runs_total{session="decode"}',
        'recoil_profiler_runs_total{session="encode"}')}
    if not all(shown.values()):
        fail(f"metrics_text() lacks stream requests or profiler runs: {shown}")
    log(f"[main] dispatch_group of {len(reqs)} = submit/flush (fused plan "
        f"reused, prepare_group counted no dispatch); corrupted register "
        f"rejected ({rejected}); dispatch_stream fault reached chunk 0; "
        f"metrics_text: {shown}")


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
    there; the plan's bucketed count is an upper bound) and the table and
    metadata bytes, which the bytes-moved count reuses.
    """
    luts = plan.args[1:4]
    splits = plan.args[4:]
    g_hi, start, stop = (splits[i].to(torch.int64) for i in (4, 5, 6))
    real = start >= 0
    real_rows = int(real.reshape(real.shape[0], -1).any(1).sum())
    row_bytes = sum(t[0].numel() * t.element_size() for t in splits)
    lut_bytes = sum(t.numel() * t.element_size() for t in luts
                    if t is not None)
    meta = real_rows * row_bytes + (real_rows * 4
                                    if plan.layout == "pointer" else 0)
    nbytes = n_words * 2 + lut_bytes + meta + n_symbols * 4
    walked = int(((start - stop + 1) * real).sum())
    steps = int(((g_hi - stop // plan.statics["ways"] + 1) * real).max())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = walked * OPS_PER_SYMBOL / INT32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, bytes_ms=bytes_ms, ops_ms=ops_ms, steps=steps,
                bound_ms=max(bytes_ms, ops_ms), lut_bytes=lut_bytes,
                meta=meta, bound_by="bytes" if bytes_ms >= ops_ms
                else "operations")


def _ring_words(plan, qf) -> int:
    """A model of the words the kernel copies into its rings (W = 32), from
    the ring geometry and not from a counter: pointer, the chunks from q0's
    down to four below qf's; symbol, the 8-row chunks from row0's down to
    the split's last row's."""
    words = plan.args[0]
    W = plan.statics["ways"]
    clip = lambda t, hi: t.clamp(0, hi)                       # noqa: E731
    if plan.layout == "pointer":
        n_stream = words.numel()
        q0 = plan.args[7].to(torch.int64)
        top = clip(q0, n_stream - 1) // POINTER_CHUNK
        low = (clip(qf.to(torch.int64), n_stream - 1) // POINTER_CHUNK
               - (RING_CHUNKS - 1)).clamp(min=0)
        return int(((top - low + 1) * POINTER_CHUNK).sum())
    g_hi, start, stop, base = (plan.args[i].to(torch.int64)
                               for i in (8, 9, 10, 7))
    last = words.numel() // W - 1
    steps = torch.minimum(g_hi - stop // W + 1,
                          torch.tensor(plan.n_steps))
    row0 = g_hi + base // W
    top = clip(row0, last) // SYMBOL_ROWS
    low = clip(row0 - steps + 1, last) // SYMBOL_ROWS
    return int(((top - low + 1) * SYMBOL_ROWS * W * (start >= 0)).sum())


def phase_times(svc, assets, enc, launches, errs, smi):
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl)
    rows = []
    for kname, name in (("walk_pointer", "zipf"), ("walk_symbol", "expo")):
        want = torch.as_tensor(assets[name].astype(np.int32), device="cuda")
        by_threads = {}
        for th in THREADS:
            plan = svc.prepare_request(name, th)
            if {"walk_symbol": "symbol",
                    "walk_pointer": "pointer"}[kname] != plan.layout:
                fail(f"{name} planned on {plan.layout}")
            ex = svc.session.executor
            kern = ex.lower(plan)
            run = dict(n_steps=plan.n_steps, n_symbols=plan.n_symbols,
                       covered=plan.covered)
            plain_fn = (_walk_batch_symbol_impl if plan.layout == "symbol"
                        else _walk_batch_impl)

            # The call the main path makes, held against the plain walk on
            # the same arguments, then timed.
            got = kern(*plan.args, **run)
            ref = plain_fn(*plan.args, **plan.statics, n_steps=plan.n_steps,
                           n_symbols=plan.n_symbols)
            qf = None
            if plan.layout == "pointer":
                _compare(kname, got[1], ref[1], errs)
                (got, qf), ref = got, ref[0]
            _compare(kname, got, ref, errs)
            if not torch.equal(got, want):
                fail(f"{kname} at {th} threads != input symbols")
            ms, host_ms = cuda_ms(lambda: ex.run(kern, plan), TIME_REPS)
            b = _bound(plan, enc[name].n_words, len(assets[name]))
            by_threads[th] = dict(ms=ms, bound=b, plan=plan)
            log(f"[times] {kname} on {name} at {th} threads: {b['steps']} "
                f"steps; {ms:.4f} ms ({ms / b['steps'] * 1e3:.3f} us/step), "
                f"host enqueue {host_ms * 1e3:.1f} us a call; bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {b['bytes']} B, "
                f"operations {b['ops_ms']:.4f} ms); "
                f"{len(assets[name]) / ms / 1e3:.1f} MB/s decoded; card: {smi}")
            ring = _ring_words(plan, qf) * 2
            blocks = -(-plan.args[4].shape[0] // (128 // plan.statics["ways"]))
            moved = ring + blocks * b["lut_bytes"] + b["meta"] + \
                plan.n_symbols * 4
            log(f"[times] {kname} at {th} threads, model of bytes moved (ring "
                f"geometry, not a counter): {moved} B = rings {ring} B "
                f"({ring / (enc[name].n_words * 2):.3f} x the stream's) + "
                f"tables {blocks} x {b['lut_bytes']} B + metadata + output")
        plan = by_threads[PLAN_THREADS]["plan"]
        plain_fn = (_walk_batch_symbol_impl if plan.layout == "symbol"
                    else _walk_batch_impl)
        plain_ms, _ = cuda_ms(lambda: plain_fn(*plan.args, **plan.statics,
                                               n_steps=plan.n_steps,
                                               n_symbols=plan.n_symbols), 2)
        log(f"[times] {kname} plain version at {PLAN_THREADS} threads: "
            f"{plain_ms:.3f} ms; card: {smi}")
        top = by_threads[PLAN_THREADS]
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": REPLACES[kname],
                     "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": top["ms"],
                     "plain_ms": plain_ms, "bound_ms": top["bound"]["bound_ms"],
                     "bound_by": top["bound"]["bound_by"], "library_ms": None,
                     "bound_bytes": top["bound"]["bytes"],
                     "ms_by_threads": {str(th): v["ms"]
                                       for th, v in by_threads.items()}})
    return rows


def _after_sleep(fn):
    """Runs ``fn(start)`` with ``start`` a timing event recorded behind a
    device sleep, so that the host queues all of ``fn``'s launches before
    the first one starts; ``fn`` returns the events to time against it.
    Returns their times after ``start`` (ms) and the host's time in
    ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t = time.perf_counter()
    marks = fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    return [start.elapsed_time(m) for m in marks], host_ms


class _MarkLaunches:
    """Inside the block, records a timing event on the current stream right
    after each launch that ``session.execute`` makes: phase 5's own marks
    between a stream's chunk launches (the service's readiness events do
    not time).  The wrapper is an instance attribute, removed on exit."""

    def __init__(self, session):
        self.session, self.marks = session, []

    def __enter__(self):
        execute = self.session.execute

        def marked(plan):
            out = execute(plan)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
            return out
        self.session.execute = marked
        return self.marks

    def __exit__(self, *exc):
        del self.session.execute


class _TimeLaunches:
    """Inside the block, brackets each launch that the calling thread makes
    through ``session.execute`` with two timing events on its current
    stream; on exit, ``ms`` holds each launch's device time (start event to
    end event).  Launches from other threads pass through unmarked.  The
    wrapper is an instance attribute, removed on exit."""

    def __init__(self, session):
        self.session, self.ms, self._pairs = session, [], []

    def __enter__(self):
        execute, me = self.session.execute, threading.get_ident()

        def bracketed(plan):
            if threading.get_ident() != me:
                return execute(plan)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = execute(plan)
            end.record()
            self._pairs.append((start, end))
            return out
        self.session.execute = bracketed
        return self

    def __exit__(self, *exc):
        del self.session.execute
        torch.cuda.synchronize()
        self.ms = [a.elapsed_time(b) for a, b in self._pairs]


def phase_stream_times(svc, assets, smi) -> None:
    """Streaming decode at 16 and 2176 threads in STREAM_CHUNKS chunks:
    the device time from the first chunk's launch to the end of chunk 0
    and of the last chunk (timing events recorded after each launch by
    ``_MarkLaunches``), the whole-asset decode's device time at the same
    threads, and ``submit_stream``'s host enqueue time on a run without
    the marks, split into the chunks' executor calls (the service
    profiler's run records) and the rest of the service's work; medians
    of TIME_REPS."""
    med = statistics.median
    prof = svc.obs.profiler
    for name in assets:
        for th in STREAM_THREADS:
            svc.submit_stream(name, th, STREAM_CHUNKS).synchronize(
                STREAM_CHUNKS - 1)
            svc.decode(name, th)
            first, last, whole, host, calls = [], [], [], [], []
            for _ in range(TIME_REPS):
                def marked_stream():
                    with _MarkLaunches(svc.session) as marks:
                        svc.submit_stream(name, th, STREAM_CHUNKS)
                    if len(marks) != STREAM_CHUNKS:
                        fail(f"a stream of {STREAM_CHUNKS} chunks made "
                             f"{len(marks)} launches")
                    return marks[0], marks[-1]
                (a, b), _ = _after_sleep(marked_stream)
                first.append(a)
                last.append(b)
                def stream():
                    svc.submit_stream(name, th, STREAM_CHUNKS)
                    return ()
                run_s = prof.totals("decode")["run_s"]
                _, h = _after_sleep(stream)
                calls.append((prof.totals("decode")["run_s"] - run_s) * 1e3)
                host.append(h)

                def decode():
                    svc.decode(name, th)
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    return (end,)
                (w,), _ = _after_sleep(decode)
                whole.append(w)
            log(f"[times] stream {name} ({svc.layout_for(name)}) at {th} "
                f"threads in {STREAM_CHUNKS} chunks: device time from the "
                f"first chunk's launch to chunk 0's end {med(first):.4f} "
                f"ms, to the last chunk's {med(last):.4f} ms; whole-asset "
                f"decode {med(whole):.4f} ms; submit_stream host enqueue "
                f"{med(host):.4f} ms, of which the {STREAM_CHUNKS} executor "
                f"calls {med(calls):.4f} ms (profiler run records) (medians "
                f"of {TIME_REPS}); card: {smi}")


def phase_observe_cost(svc, assets, smi) -> None:
    """What the service's instrumentation costs on the host: the warm
    ``decode`` (host clock to its synchronize) and ``submit_stream`` in
    STREAM_CHUNKS chunks (host clock to its return, and to the
    synchronize after it) at OBSERVE_THREADS, on ``svc`` (``observe=True``)
    and on a service with ``observe=False`` serving the same resident
    content, the two interleaved call by call; medians of TIME_REPS."""
    from repro_torch.runtime.serve import DecodeService
    quiet = DecodeService(svc.session.model, device=svc.session.device,
                          observe=False)
    for name in assets:
        c = svc.content(name)
        quiet.register(name, c.plan, c.stream, c.final_states)
        if quiet.layout_for(name) != svc.layout_for(name):
            fail(f"{name} registered on another layout without observe")
    med = statistics.median
    th = OBSERVE_THREADS

    def timed(fn):
        """Host ms to ``fn``'s return and to the synchronize after it."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t) * 1e3, (time.perf_counter() - t) * 1e3
    for name in assets:
        res = {}
        for s in (svc, quiet):
            s.decode(name, th)
            s.submit_stream(name, th, STREAM_CHUNKS).result()
            res[s] = {"decode": [], "enqueue": [], "stream": []}
        for _ in range(TIME_REPS):
            for s in (svc, quiet):
                _, ms = timed(lambda: s.decode(name, th))
                res[s]["decode"].append(ms)
                q, ms = timed(lambda: s.submit_stream(name, th,
                                                      STREAM_CHUNKS))
                res[s]["enqueue"].append(q)
                res[s]["stream"].append(ms)
        on, off = ({k: med(v) for k, v in res[s].items()}
                   for s in (svc, quiet))
        log(f"[times] observe cost {name} at {th} threads, observe=True vs "
            f"observe=False (interleaved, medians of {TIME_REPS}): warm "
            f"decode to synchronize {on['decode']:.4f} vs "
            f"{off['decode']:.4f} ms; submit_stream in {STREAM_CHUNKS} "
            f"chunks, host enqueue {on['enqueue']:.4f} vs "
            f"{off['enqueue']:.4f} ms, to synchronize {on['stream']:.4f} vs "
            f"{off['stream']:.4f} ms; card: {smi}")


def phase_broker_times(svc, assets, smi) -> None:
    """The pipeline broker's end-to-end latency on expo at STREAM_THREADS:
    a closed loop of BROKER_REPS requests, host clock from ``submit`` until
    ``result()`` returns (the broker has waited for the launch's readiness
    event), each followed by the sync path's ``decode`` and a wait on an
    event recorded after it; first on an idle ingest worker, then while it
    ingests a 10 MB asset back to back, with the broker's overlap ratio and
    its wait/service summaries.  An idle loop with the predictor off comes
    first.  Each loop's line also gives what ``warm()`` cost before it
    (groups launched, host wall time, and the sum of its launches' device
    times) and the predictor's idle-gap units during the loop (prethins,
    warm probes, and warm launches, which share the stream with the
    traffic).
    Then ``submit_stream`` in STREAM_CHUNKS
    chunks through the broker and on a service without one serving the
    same content (interleaved): host time to chunk 0 and to the last
    chunk, medians of TIME_REPS."""
    from repro_torch.runtime.pipeline import ControllerConfig
    from repro_torch.runtime.serve import DecodeService
    name = "expo"
    want = torch.as_tensor(assets[name].astype(np.int32), device="cuda")
    load = _expo(102)
    pct = lambda xs, p: float(np.percentile(xs, p))         # noqa: E731

    def sync_decode(th):
        svc.decode(name, th)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    variants = (("idle, predictor off", False, False), ("idle", True, False),
                ("under back-to-back 10 MB ingests", True, True))
    for th in STREAM_THREADS:
        for label, predictive, loaded in variants:
            b = svc.start_pipeline(config=ControllerConfig(max_batch=8),
                                   predictive=predictive)
            with _TimeLaunches(svc.session) as warm_launches:
                t = time.perf_counter()
                b.warm([name], [th])
                warm_wall = (time.perf_counter() - t) * 1e3
            pred0 = b.snapshot()["predictive"]
            stop, done = threading.Event(), []

            def loader():
                while not stop.is_set():
                    b.submit_ingest("t_load", load, PLAN_THREADS).result(
                        timeout=120)
                    done.append(1)
            worker = threading.Thread(target=loader) if loaded else None
            if worker is not None:
                worker.start()
                while not done and worker.is_alive():
                    time.sleep(0.001)     # the first ingest has finished
            broker_ms, sync_ms = [], []
            for i in range(BROKER_REPS):
                t = time.perf_counter()
                out = svc.submit(name, th).result(timeout=120)
                broker_ms.append((time.perf_counter() - t) * 1e3)
                if i % 50 == 0 and not torch.equal(out, want):
                    fail(f"broker {name} at {th} threads != input symbols")
                t = time.perf_counter()
                sync_decode(th)
                sync_ms.append((time.perf_counter() - t) * 1e3)
            stop.set()
            if worker is not None:
                worker.join(timeout=300)
            b.drain(timeout=120)
            snap = b.snapshot()
            svc.stop_pipeline()
            pred = ("off" if pred0 is None else ", ".join(
                f"{snap['predictive'][k] - pred0[k]} {k}"
                for k in ("prethins", "warm_probes", "warm_compiles")))
            w, s = snap["wait"], snap["service"]
            log(f"[times] broker {name} at {th} threads, {label}, "
                f"closed loop of {BROKER_REPS}: submit to result() p50 "
                f"{pct(broker_ms, 50):.4f} ms, p99 {pct(broker_ms, 99):.4f} "
                f"ms; sync decode to its event, interleaved: p50 "
                f"{pct(sync_ms, 50):.4f} ms, p99 {pct(sync_ms, 99):.4f} ms; "
                f"broker wait p50 {w['p50_ms']:.4f} / p99 {w['p99_ms']:.4f} "
                f"ms, service p50 {s['p50_ms']:.4f} / p99 {s['p99_ms']:.4f} "
                f"ms; overlap ratio {snap['overlap']['overlap_ratio']:.4f}; "
                f"ingests done {len(done)}, groups "
                f"{snap['dispatch_groups']}; warm() before it: "
                f"{len(warm_launches.ms)} groups, wall {warm_wall:.4f} ms, "
                f"device {sum(warm_launches.ms):.4f} ms; predictor units "
                f"during the loop: {pred}; card: {smi}")

    direct = DecodeService(svc.session.model, device=svc.session.device)
    c = svc.content(name)
    direct.register(name, c.plan, c.stream, c.final_states)
    b = svc.start_pipeline(config=ControllerConfig(max_batch=8))
    med = statistics.median
    for th in STREAM_THREADS:
        times = {"broker": ([], []), "direct": ([], [])}
        for rep in range(TIME_REPS + 1):
            for path, submit in (("broker", b.submit_stream),
                                 ("direct", direct.submit_stream)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                st = submit(name, th, STREAM_CHUNKS)
                st.synchronize(0, timeout=120)
                first = time.perf_counter() - t
                last_chunk = st.synchronize(STREAM_CHUNKS - 1, timeout=120)
                last = time.perf_counter() - t
                if rep == 0:              # warm-up, checked, not timed
                    spec = st.specs[-1]
                    if not torch.equal(last_chunk, want[
                            spec.base:spec.base + spec.length]):
                        fail(f"{path} stream's last chunk != its symbols")
                    continue
                times[path][0].append(first * 1e3)
                times[path][1].append(last * 1e3)
        (bf, bl), (df, dl) = times["broker"], times["direct"]
        log(f"[times] stream {name} at {th} threads in {STREAM_CHUNKS} "
            f"chunks, host clock from submit_stream to chunk 0 / the last "
            f"chunk ready (medians of {TIME_REPS}, interleaved): through "
            f"the broker {med(bf):.4f} / {med(bl):.4f} ms; direct "
            f"{med(df):.4f} / {med(dl):.4f} ms; card: {smi}")
    b.drain(timeout=120)
    svc.stop_pipeline()


def _sm_clock_hz() -> float:
    """The card's top SM clock, from nvidia-smi (MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _median_ms(fn, reps: int, before=None) -> float:
    """Median host-clock time of ``fn()`` ended by a synchronize, over
    ``reps`` runs after one warm-up; ``before()`` runs untimed ahead of
    each."""
    times = []
    for i in range(reps + 1):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def _profile_ingest(svc, symbols) -> None:
    """Where one warm ingest's time goes: ``torch.profiler`` over one
    ``svc.ingest``, the device time of each kernel and copy (they run one
    at a time on the stream, so their sum is the device's busy time) and
    the host's self time by operation."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        svc.ingest("t_profile", symbols, PLAN_THREADS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # Device-side events only (kernels and copies): an operator's device
    # time repeats its kernels'.  The profiler's own buffer request is not
    # the program's work.
    dev = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.key,
                   e.count) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Activity Buffer" not in e.key), reverse=True)
    busy = sum(ms for ms, _, _ in dev)
    if busy == 0:
        log("[profile] the profiler saw no device time: device busy and "
            "idle share not measured")
        return
    log(f"[profile] one warm ingest of expo under torch.profiler: wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms (sum of kernel times), "
        f"device idle share {1 - busy / wall:.3f}")
    for ms, key, n in dev[:8]:
        log(f"[profile]   device {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events), reverse=True)
    for ms, key, n in host[:10]:
        log(f"[profile]   host   {ms:9.3f} ms  x{n:<5d} {key[:90]}")


def phase_ingest_times(svc, assets, launches, errs, smi, sass):
    """Warm ingest and extend latency through the service, then each ingest
    kernel at the main path's shapes (the expo asset, 2176 splits): held
    against its plain version on the same arguments, CUDA-event device
    time, bound, plain version's time."""
    from repro_torch.core.encode import ops
    from repro_torch.kernels.rans_encode import rans_encode as re_
    raw = {k: v.astype(np.uint8) for k, v in assets.items()}
    for name in assets:
        ms = _median_ms(lambda: svc.ingest(f"t_{name}", raw[name],
                                           PLAN_THREADS), INGEST_REPS)
        log(f"[times] warm ingest of {name} (10 MB, {PLAN_THREADS} splits): "
            f"median {ms:.3f} ms of {INGEST_REPS}; card: {smi}")
    expo = raw["expo"]
    ms = _median_ms(lambda: svc.extend("t_ext", expo[EXTEND_AT:]),
                    INGEST_REPS, before=lambda: svc.ingest(
                        "t_ext", expo[:EXTEND_AT], PLAN_THREADS))
    log(f"[times] warm extend of 9 MB by 1 MB: median {ms:.3f} ms of "
        f"{INGEST_REPS}; card: {smi}")

    _profile_ingest(svc, raw["expo"])

    coder = svc._encode_session()
    plan = coder.prepare(expo, PLAN_THREADS)
    sym, active, f, F, n_sym, n_splits, _, x0 = plan.args
    B, G, W = sym.shape
    clock = _sm_clock_hz()
    enc_args = (sym, active, f, F, x0)
    # The call the main path makes: with the executor's encoder records, so
    # no table is built inside the timed calls.
    table = coder.executor.table
    got = re_.encode_scan(*enc_args, n_bits=N_BITS, table=table)
    want = []
    plain_ms, _ = cuda_ms(lambda: want.extend(re_.encode_scan_plain(
        *enc_args, n_bits=N_BITS)), 1, warm=False)
    for g, w in zip(got, want):
        _compare("encode_scan", g, w, errs)
    ms, _ = cuda_ms(lambda: re_.encode_scan(*enc_args, n_bits=N_BITS,
                                            table=table), INGEST_REPS)
    # Bytes: 4 B symbol and 1 B flag in, 2 B word, 1 B mask and 4 B y out
    # per grid slot, x0 and the final states, the 16-byte records.
    nbytes = B * G * W * (4 + 1 + 2 + 1 + 4) + B * W * 8 + \
        table.records.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = G * ENCODE_STEP_OPS * CYCLES_PER_DEPENDENT_OP / clock * 1e3
    rows = [{"name": "encode_scan", "route": "cuda",
             "source": SOURCES["encode_scan"],
             "replaces": REPLACES["encode_scan"],
             "launches": launches["encode_scan"],
             "max_abs_err": errs["encode_scan"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(bytes_ms, chain_ms),
             "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
             "library_ms": None, "bound_bytes": nbytes}]
    # Cycles a group step: the measured time at the top SM clock that
    # nvidia-smi reports, not a cycle count.
    log(f"[times] encode_scan on expo ({G} groups x {W} ways, the "
        f"executor's table): {ms:.4f} ms ({ms / G * 1e6:.1f} ns a group "
        f"step, {ms * 1e-3 * clock / G:.1f} cycles a group step at the top "
        f"SM clock, {clock / 1e6:.0f} MHz); bound {rows[0]['bound_ms']:.4f} ms "
        f"({rows[0]['bound_by']}: chain_ms, a model: {G} steps x "
        f"{ENCODE_STEP_OPS} dependent operations x {CYCLES_PER_DEPENDENT_OP} "
        f"cycles = {chain_ms:.4f} ms; the build's SASS: {sass[0]:g} "
        f"instructions a step on the state's chain, {sass[1]:g} issued by "
        f"the chain warp; bytes_ms {nbytes} B = "
        f"{bytes_ms:.4f} ms); plain version {plain_ms:.1f} ms; card: {smi}")

    words, masks, ys, _, _ = got
    csum, last, n_words = ops.emission_layout(masks)
    nw = int(n_words[0])
    _, kw, _ = ops.compact_emissions(words, ys, masks, csum, nw)
    pargs = (kw, csum, last, ys, n_words.int(), n_sym, n_splits)
    st = dict(window=WINDOW, n_slots=PLAN_THREADS - 1)
    got = re_.plan_splits(*pargs, **st)
    want = []
    plain_ms, _ = cuda_ms(lambda: want.extend(re_.plan_splits_plain(
        *pargs, **st)), 1, warm=False)
    for g, w in zip(got, want):
        _compare("plan_splits", g, w, errs)
    ms, _ = cuda_ms(lambda: re_.plan_splits(*pargs, **st), INGEST_REPS)
    S = int(got[0].sum())
    # Bytes: the winners' reads (k_of_word, csum, W last[] and y entries)
    # and the outputs (found, q, k[W], y[W]) of each found slot.
    nbytes = S * (13 + 16 * W)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    levels = (W - 1).bit_length() + (2 * WINDOW).bit_length()
    chain_ms = (S * (PLAN_SLOT_OPS + levels) * CYCLES_PER_DEPENDENT_OP
                / clock * 1e3)
    rows.append({"name": "plan_splits", "route": "cuda",
                 "source": SOURCES["plan_splits"],
                 "replaces": REPLACES["plan_splits"],
                 "launches": launches["plan_splits"],
                 "max_abs_err": errs["plan_splits"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": max(bytes_ms, chain_ms),
                 "bound_by": "bytes" if bytes_ms >= chain_ms
                 else "operations", "library_ms": None,
                 "bound_bytes": nbytes})
    # The design's own model: the cover pass's bytes (last, and k_of_word
    # and c of each word, once each) at the HBM rate, and two dependent
    # memory round trips a slot (the center, then its window).
    cover_bytes = B * G * W * 4 + nw * 8
    model_ms = (cover_bytes / HBM_BYTES_PER_S * 1e3
                + S * 2 * PLAN_ROUND_TRIP_CYCLES / clock * 1e3)
    log(f"[times] plan_splits on expo ({S} split points of {nw} words): "
        f"{ms:.4f} ms ({ms / S * 1e3:.3f} us a slot); bound "
        f"{rows[1]['bound_ms']:.4f} ms ({rows[1]['bound_by']}: chain_ms, a "
        f"model: {S} slots x ({PLAN_SLOT_OPS} + log2 {W} + ceil log2 "
        f"{2 * WINDOW + 1} = {PLAN_SLOT_OPS + levels}) dependent operations "
        f"x {CYCLES_PER_DEPENDENT_OP} cycles at {clock / 1e6:.0f} MHz = "
        f"{chain_ms:.4f} ms; bytes_ms {nbytes} B = {bytes_ms:.6f} ms); the "
        f"design's model {model_ms:.4f} ms (cover pass {cover_bytes} B at "
        f"3.35 TB/s + {S} slots x 2 round trips x {PLAN_ROUND_TRIP_CYCLES} "
        f"cycles); plain version {plain_ms:.1f} ms; card: {smi}")
    _profile_planner(pargs, st, got, S, smi)
    return rows


def _profile_planner(pargs, st, plan, S, smi) -> None:
    """How one planner call's device time splits between its three kernels
    (``torch.profiler`` over INGEST_REPS calls), and the round in which
    each of the expo plan's slots was won."""
    from torch.profiler import ProfilerActivity, profile
    from torch_checks import won_rounds

    from repro_torch.kernels.rans_encode import rans_encode as re_
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(INGEST_REPS):
            re_.plan_splits(*pargs, **st)
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        for k in ("plan_cover_kernel", "plan_chain_kernel",
                  "plan_emit_kernel"):
            if k in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                parts[k] = getattr(e, "self_device_time_total", 0) / 1e3 \
                    / INGEST_REPS
    if len(parts) != 3 or not all(parts.values()):
        log("[profile] the profiler saw no planner kernel time: the split "
            "between the planner's kernels is not measured")
    else:
        log(f"[profile] one plan_splits call on expo under torch.profiler "
            f"(mean of {INGEST_REPS}): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; the chain {parts['plan_chain_kernel'] / S * 1e3:.3f} us a "
            f"slot; card: {smi}")
    kw, csum, last, _, n_words, n_symbols, n_splits = pargs
    cover = re_.plan_cover(kw, last, n_words)
    won = won_rounds(*(t.cpu() for t in (plan[1], plan[0], cover, csum,
                                         n_words, n_symbols, n_splits)),
                     window=st["window"])
    counts = torch.bincount(won[won >= 0]).tolist()
    log(f"[times] plan_splits on expo: slots won by round {counts}")


SWEEP_ROWS_PER_BLOCK = (None, 1, 2, 4, 8, 16, 32)   # warps a block at W 32
TUNE_SIZES = (1 * MB, 4 * MB, 10 * MB)


def _sweep_rows_per_block(svc, assets, rd, errs, smi) -> None:
    """Both walks at every rows_per_block the W = 32 plans allow, on the main
    path's plans at THREADS: each launch bit-equal to the plain walk, the
    default launch and the symbols, then its CUDA-event time (mean of
    TIME_REPS)."""
    from repro_torch.core.vectorized import (_walk_batch_impl,
                                             _walk_batch_symbol_impl)
    for kname, name in (("walk_pointer", "zipf"), ("walk_symbol", "expo")):
        want = torch.as_tensor(assets[name].astype(np.int32), device="cuda")
        fn = getattr(rd, f"walk_decode_{kname.split('_')[1]}")
        for th in THREADS:
            plan = svc.prepare_request(name, th)
            run = dict(**plan.statics, n_steps=plan.n_steps,
                       n_symbols=plan.n_symbols, covered=plan.covered)
            plain = (_walk_batch_symbol_impl if plan.layout == "symbol"
                     else _walk_batch_impl)(*plan.args, **plan.statics,
                                            n_steps=plan.n_steps,
                                            n_symbols=plan.n_symbols)
            plain = plain if plan.layout == "symbol" else plain[0]
            base = fn(*plan.args, **run)
            base = base if plan.layout == "symbol" else base[0]
            times = {}
            for rpb in SWEEP_ROWS_PER_BLOCK:
                got = fn(*plan.args, **run, rows_per_block=rpb)
                got = got if plan.layout == "symbol" else got[0]
                _compare(kname, got, plain, errs)
                if not (torch.equal(got, base) and torch.equal(got, want)):
                    fail(f"{kname} at rows_per_block={rpb}, {th} threads "
                         "differs from the default launch or the symbols")
                times[rpb], _ = cuda_ms(
                    lambda: fn(*plan.args, **run, rows_per_block=rpb),
                    TIME_REPS)
            cells = "; ".join(f"{r}: {t:.4f}" for r, t in times.items())
            log(f"[tuning] rows_per_block sweep, {kname} on {name} at {th} "
                f"threads, bit-equal to the plain walk and the default "
                f"(device ms, CUDA events, mean of {TIME_REPS}; None = 128 "
                f"threads, r = 32 r threads): {cells}; card: {smi}")


def phase_tuning(svc, assets, rd, re_, errs, smi) -> dict:
    """The autotuner and a tuned service on the card (phase 6).

    First the rows_per_block sweep (comparisons, not counted).  Then, with
    every count at 0: ``Autotuner(device="cuda")`` on TUNE_SIZES with
    PLAN_THREADS-split plans into a temporary database (never the user
    cache), which must measure and key ``cuda:cuda:auto``, and a second
    tuner on the same workload, which must measure nothing; a
    ``REPRO_TUNING_DB`` that fails to load must raise; then a
    ``DecodeService(policy=<that profile>)`` ingests expo and registers
    zipf's resident stream, decodes both at THREADS and in a fused group,
    bit-equal, repeats that traffic warm without resolving a launcher, and
    its broker takes the profile's microbatch sizes.  Returns this path's
    launches."""
    import tempfile
    from repro_torch.core.tuning import (Autotuner, TuningSchemaError,
                                         user_db_path)
    from repro_torch.runtime.serve import DecodeService
    _sweep_rows_per_block(svc, assets, rd, errs, smi)
    rd.reset_counts()
    re_.reset_counts()
    cache = user_db_path()
    cache_before = cache.stat().st_mtime_ns if cache.exists() else None
    with tempfile.TemporaryDirectory() as tmp:
        db_path = os.path.join(tmp, "tuning.json")
        t = time.perf_counter()
        tuner = Autotuner(device="cuda", n_splits=PLAN_THREADS)
        prof = tuner.tune(TUNE_SIZES, db_path=db_path)
        took = time.perf_counter() - t
        if tuner.measurements == 0 or prof.key != "cuda:cuda:auto":
            fail(f"the tuner made {tuner.measurements} measurements under "
                 f"{prof.key!r}")
        fit = prof.meta
        sweep = fit["rows_per_block_sweep"]
        log(f"[tuning] Autotuner(device='cuda') on {TUNE_SIZES} symbols with "
            f"{PLAN_THREADS}-split plans: {tuner.measurements} measurements "
            f"in {took:.1f} s; key {prof.key}; fit: launcher resolve "
            f"{fit['compile_s'] * 1e6:.3f} us a key (the first call's host "
            f"time beyond a warm call's), execute (device) "
            f"{fit['exec_intercept_s'] * 1e6:.3f} us + "
            f"{fit['exec_slope_s'] * 1e9:.4f} ns x steps bucket; probes "
            f"(rung, resolve s, warm device s) {fit['probes']}; card: {smi}")
        log(f"[tuning] derived work ladder ({len(prof.work_ladder)} rungs): "
            f"{list(prof.work_ladder)}; microbatch sizes "
            f"{list(prof.microbatch_sizes)}; rows_per_block "
            f"{prof.rows_per_block} from the timed sweep "
            f"{ {k: v.get('warm_s') for k, v in sweep['candidates'].items()} }"
            f" (s, CUDA events behind a device sleep, median of "
            f"{tuner.repeats}); card: {smi}")
        again = Autotuner(device="cuda", n_splits=PLAN_THREADS)
        if again.tune(TUNE_SIZES, db_path=db_path) != prof or \
                again.measurements != 0:
            fail(f"a second tuner on the same workload made "
                 f"{again.measurements} measurements")
        log("[tuning] a second tuner on the same workload: 0 measurements, "
            "the stored profile")
        bad = os.path.join(tmp, "bad.json")
        with open(bad, "w") as f:
            json.dump({"schema": 0, "profiles": {}}, f)
        os.environ["REPRO_TUNING_DB"] = bad
        try:
            DecodeService(svc.session.model, device="cuda")
        except TuningSchemaError:
            pass
        else:
            fail("a REPRO_TUNING_DB that fails to load did not raise")
        finally:
            del os.environ["REPRO_TUNING_DB"]
    if (cache.stat().st_mtime_ns if cache.exists() else None) != cache_before:
        fail(f"the tuner wrote the user cache {cache}")

    tuned = DecodeService(svc.session.model, device="cuda", policy=prof)
    if tuned.tuning_profile is not prof:
        fail("the tuned service does not report its profile")
    tuned.ingest("expo", assets["expo"].astype(np.uint8), PLAN_THREADS)
    z = svc.content("zipf")
    tuned.register("zipf", z.plan, z.stream, z.final_states)
    if {k: tuned.layout_for(k) for k in assets} != \
            {"expo": "symbol", "zipf": "pointer"}:
        fail("the tuned service's layouts differ from the main path's")
    want = {k: torch.as_tensor(v.astype(np.int32), device="cuda")
            for k, v in assets.items()}
    reqs = [(n, th) for th in THREADS for n in assets]

    def traffic():
        for name, th in reqs:
            if not torch.equal(tuned.decode(name, th), want[name]):
                fail(f"tuned {name} at {th} threads != input symbols")
        tickets = [tuned.submit(n, th) for n, th in reqs]
        tuned.flush()
        for (name, th), tk in zip(reqs, tickets):
            if not torch.equal(tk.result(), want[name]):
                fail(f"tuned fused {name} at {th} threads != input symbols")

    traffic()
    keys = tuned.session.stats.compiles
    traffic()
    if tuned.session.stats.compiles != keys:
        fail("the tuned service's warm round resolved a launcher")
    if any(isinstance(k, tuple) and prof.policy().tag not in k
           for k in tuned.session._exec):
        fail("a tuned plan key lacks the profile's tag")
    enc = tuned._encode_session()
    with tuned.start_pipeline() as broker:
        sizes = broker.controller.cfg.sizes()
        if sizes != tuple(sorted(prof.microbatch_sizes)):
            fail(f"the broker's sizes {sizes} are not the profile's")
        for name, th in reqs[:2]:
            if not torch.equal(broker.submit(name, th).result(timeout=60),
                               want[name]):
                fail(f"tuned broker {name} at {th} threads != input symbols")
    tuned.stop_pipeline()
    torch.cuda.synchronize()
    launches = {"walk_pointer": rd.walk_decode_pointer.launches,
                "walk_symbol": rd.walk_decode_symbol.launches,
                "encode_scan": re_.encode_scan.launches,
                "plan_splits": re_.plan_splits.launches}
    plain = (rd.walk_decode_pointer.plain_calls
             + rd.walk_decode_symbol.plain_calls
             + re_.encode_scan.plain_calls + re_.plan_splits.plain_calls)
    if min(launches.values()) == 0 or plain != 0:
        fail(f"the tuning path's launches {launches}, plain versions {plain}")
    log(f"[tuning] tuned service ({tuned.session.policy.tag}): both assets at "
        f"{THREADS} threads and a fused group of {len(reqs)}, bit-exact, "
        f"twice; {keys} keys resolved, 0 in the warm round; its encoder's "
        f"policy {enc.policy.tag} (profile "
        f"{enc.tuning_profile and enc.tuning_profile.key}); broker sizes "
        f"{sizes}; this path's launches {launches}, plain versions 0")
    return launches


# Phase 7: the sharded executor on meshes that repeat the one card.
SHARD_COUNTS = (1, 2, 4)


def _shard_rows(plan) -> list:
    """Real rows of each shard of a sharded plan (0 for an empty one)."""
    n_shards = plan.key[3]
    rows = [0] * n_shards
    for sh in plan.args:
        rows[sh.shard] = sh.rows[1] - sh.rows[0]
    return rows


def _run_example(name: str) -> float:
    """``examples/<name>.py``'s ``main()`` on the card (its lines go to
    this log); returns its wall time in seconds."""
    import importlib.util
    path = os.path.join(os.path.dirname(SRC), "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    log(f"[shards] examples/{name}.py main() on the card:")
    t = time.perf_counter()
    module.main()
    sys.stdout.flush()
    return time.perf_counter() - t


def phase_shards(svc, assets, rd, re_, smi) -> dict:
    """The sharded executor on the card (phase 7).

    Sharded sessions over ``(cuda:0,) * k`` for k in SHARD_COUNTS and the
    2 x 2 smoke mesh decode both assets of the main path at THREADS, each
    equal to the symbols and to the main service's unsharded decode, with
    each shard's rows, slab and launch printed and the partition held to
    the reference's formula; a second round resolves no launcher.  Then a
    sharded ``DecodeService`` (4 entries, microbatch 8) runs a fused group
    twice and the pipeline stress on the card, and both examples run
    through their ``main()``.  Every count is 0 before and read after this
    path; then the CUDA-event times.  Returns this path's launches."""
    from repro_torch.core.engine import DecoderSession
    from repro_torch.core.recoil import build_split_states, combine_plan
    from repro_torch.core.vectorized import WalkBatch
    from repro_torch.launch.mesh import make_decode_mesh, make_smoke_mesh
    from repro_torch.parallel.decode_shard import gather_slabs
    from repro_torch.runtime.serve import DecodeService
    from torch_checks import stress_payloads, threaded_stress
    dev = svc.session.device
    model = svc.session.model
    want = {k: torch.as_tensor(v.astype(np.int32), device=dev)
            for k, v in assets.items()}
    reqs = [(n, th) for n in assets for th in THREADS]
    whole = {r: svc.decode(*r) for r in reqs}        # the unsharded decodes
    batches = {}
    for name, th in reqs:
        c = svc.content(name)
        plan = combine_plan(c.plan, th)
        batches[(name, th)] = (WalkBatch.from_splits(
            build_split_states(plan, c.final_states), plan.ways),
            plan.n_symbols, c.stream)
    meshes = {f"k={k}": make_decode_mesh(devices=(dev,) * k)
              for k in SHARD_COUNTS}
    meshes["smoke 2x2"] = make_smoke_mesh(devices=(dev,) * 4)
    torch.cuda.synchronize()

    rd.reset_counts()
    re_.reset_counts()
    t_phase = time.perf_counter()
    sessions, plans = {}, {}
    for label, mesh in meshes.items():
        sess = sessions[label] = DecoderSession(model, impl="sharded",
                                                mesh=mesh)
        if sess.device != dev or sess.impl != "sharded":
            fail(f"{label}: session on {sess.device}, impl {sess.impl}")
        for rnd in range(2):
            before = sess.stats.compiles
            for name, th in reqs:
                batch, n, ds = batches[(name, th)]
                plan = plans[(label, name, th)] = sess.prepare(batch, ds, n)
                walk = (rd.walk_decode_symbol if plan.layout == "symbol"
                        else rd.walk_decode_pointer)
                launched = walk.launches
                out = sess.execute(plan)
                launched = walk.launches - launched
                if not (torch.equal(out, want[name])
                        and torch.equal(out, whole[(name, th)])):
                    fail(f"{label} {name} at {th} threads != the symbols "
                         "or the unsharded decode")
                if launched != len(plan.args):
                    fail(f"{label} {name} at {th} threads: {launched} walk "
                         f"launches for {len(plan.args)} shards with rows")
                if rnd:
                    continue
                n_shards, s_b = plan.key[3], plan.key[8]
                per = svc.session.policy.work(
                    -(-batch.k.shape[0] // n_shards))
                expect = [max(0, min(per, batch.k.shape[0] - s * per))
                          for s in range(n_shards)]
                rows = _shard_rows(plan)
                if rows != expect or s_b != per * n_shards:
                    fail(f"{label} {name} at {th}: rows {rows}, the "
                         f"reference's formula gives {expect}")
                bucket = ds.sym_bucket if plan.layout == "symbol" \
                    else ds.bucket
                log(f"[shards] {label} {name} ({plan.layout}) at {th} "
                    f"threads: {batch.k.shape[0]} splits, bucket {s_b}; "
                    f"rows {rows}; words read {[sh.span for sh in plan.args]}"
                    f" in slabs of {plan.key[10]}, of {bucket} words; "
                    f"steps {[sh.n_steps for sh in plan.args]} of "
                    f"{batch.n_steps}; launches {launched} (one a shard "
                    "with rows)")
            if rnd and sess.stats.compiles != before:
                fail(f"{label}: the warm round resolved "
                     f"{sess.stats.compiles - before} launchers")
        log(f"[shards] {label}: {len(reqs)} decodes x 2 rounds bit-equal to "
            f"the symbols and the unsharded decode; "
            f"{sess.stats.compiles} launchers resolved, 0 in the warm round")

    # An hour-scale delay: a group leaves only at flush(), however long a
    # 10 MB request's first thinning takes.
    sharded = DecodeService(model, impl="sharded", mesh=meshes["k=4"],
                            microbatch=8, max_delay_ms=3_600_000.0)
    sharded.ingest("expo", assets["expo"].astype(np.uint8), PLAN_THREADS)
    z = svc.content("zipf")
    sharded.register("zipf", z.plan, z.stream, z.final_states)
    group = [("expo", 2176), ("zipf", 2176), ("expo", 128), ("zipf", 16)]
    for _ in range(2):
        tickets = [sharded.submit(n, th) for n, th in group]
        sharded.flush()
        for (name, th), tk in zip(group, tickets):
            if not torch.equal(tk.result(), want[name]):
                fail(f"sharded fused {name} at {th} threads != the symbols")
    st = sharded.stats
    if st.fused_dispatches != 2 or st.compiles != 1 or st.cache_hits != 1:
        fail(f"sharded fused group: {st.snapshot()}, expected 2 fused "
             "dispatches, 1 launcher resolved, 1 cache hit")
    log(f"[shards] sharded DecodeService (4 entries, microbatch 8): a fused "
        f"group of {len(group)} twice, bit-exact; fused dispatches "
        f"{st.fused_dispatches}, compiles {st.compiles}, cache hits "
        f"{st.cache_hits}")
    t = time.perf_counter()
    payloads = stress_payloads()
    sharded.ingest_batch(payloads, 16)
    snap = threaded_stress(sharded, payloads, 120.0)
    log(f"[shards] broker stress on the sharded service: 60 results "
        f"bit-exact during 6 x 3 re-ingests, dispatch errors "
        f"{snap['dispatch_errors']}, ingest errors {snap['ingest_errors']}, "
        f"overlap ratio {snap['overlap']['overlap_ratio']:.3f}, "
        f"{time.perf_counter() - t:.1f} s")
    took = {name: _run_example(name)
            for name in ("quickstart_torch", "content_delivery_torch")}
    torch.cuda.synchronize()
    launches = {"walk_pointer": rd.walk_decode_pointer.launches,
                "walk_symbol": rd.walk_decode_symbol.launches,
                "encode_scan": re_.encode_scan.launches,
                "plan_splits": re_.plan_splits.launches}
    plain = (rd.walk_decode_pointer.plain_calls
             + rd.walk_decode_symbol.plain_calls
             + re_.encode_scan.plain_calls + re_.plan_splits.plain_calls)
    if min(launches.values()) == 0 or plain != 0:
        fail(f"the sharded path's launches {launches}, plain versions "
             f"{plain}")
    log(f"[shards] examples ran in "
        f"{ {k: round(v, 1) for k, v in took.items()} } s; this path's "
        f"launches {launches}, plain versions 0, output fills "
        f"{rd.walk_decode_pointer.fills + rd.walk_decode_symbol.fills}; "
        f"{time.perf_counter() - t_phase:.1f} s")

    # Device times: CUDA events behind a device sleep, mean of TIME_REPS.
    # A sharded decode's execute is its shards' fills and walks and the
    # merge; its plan's slab gather (memoized with the plan) is timed apart.
    for name, th in reqs:
        unsharded = svc.prepare_request(name, th)
        base, _ = cuda_ms(lambda: svc.session.execute(unsharded), TIME_REPS)
        parts = []
        for k in SHARD_COUNTS:
            label = f"k={k}"
            sess, plan = sessions[label], plans[(label, name, th)]
            ms, _ = cuda_ms(lambda: sess.execute(plan), TIME_REPS)
            fn = sess._exec[plan.key]
            walks = [cuda_ms(lambda sh=sh: fn(
                *sh.args, n_steps=sh.n_steps, n_symbols=plan.n_symbols,
                covered=False), TIME_REPS)[0] for sh in plan.args]
            ds = batches[(name, th)][2]
            src = ds.by_symbol if plan.layout == "symbol" else ds.words
            origins = torch.as_tensor([sh.origin for sh in plan.args],
                                      device=dev)
            bucket = ds.sym_bucket if plan.layout == "symbol" else ds.bucket
            gather, _ = cuda_ms(lambda: gather_slabs(
                src, origins, plan.key[10], bucket), TIME_REPS)
            parts.append(f"k={k} {ms:.4f} ms (shard walks "
                         f"{', '.join(f'{w:.4f}' for w in walks)}; plan's "
                         f"slab gather {gather:.4f})")
        log(f"[shards] times {name} at {th} threads: unsharded {base:.4f} "
            f"ms; " + "; ".join(parts) + f"; card: {smi}")
    return launches


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, SRC)
    sys.path.insert(0, TESTS)
    from repro_torch.kernels.rans_decode import rans_decode as rd
    from repro_torch.kernels.rans_encode import rans_encode as re_
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sass = phase_build([rd.LIBRARY, re_.LIBRARY])
    errs: dict = {}
    phase_kernels(dev, errs)
    phase_walk_coverage(dev, errs)
    phase_encode_kernels(dev, errs)
    phase_plan_kernels(dev, errs)
    svc, assets, enc, launches = phase_main(dev, rd, re_)
    rows = phase_times(svc, assets, enc, launches, errs, smi)
    phase_stream_times(svc, assets, smi)
    phase_observe_cost(svc, assets, smi)
    phase_broker_times(svc, assets, smi)
    rows += phase_ingest_times(svc, assets, launches, errs, smi, sass)
    for phase in (phase_tuning(svc, assets, rd, re_, errs, smi),
                  phase_shards(svc, assets, rd, re_, smi)):
        for name, n in phase.items():
            for row in rows:
                if row["name"] == name:
                    row["launches"] += n
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

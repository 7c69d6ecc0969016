// Recoil ingest for NVIDIA Hopper (sm_90a): the W-way interleaved rANS
// encode and the Definition-4.1 split planner.
//
// The JAX package runs both as lax.scan loops that XLA compiles into one
// sequential device loop each; there is no Pallas kernel for them.  These
// kernels replace
//   encode_scan_kernel <- src/repro/core/encode/ops.py  encode_scan
//   plan_cover_kernel, plan_chain_kernel, plan_emit_kernel
//                      <- src/repro/core/encode/ops.py  plan_split_scan
// and compute exactly what those functions compute (the emission layout and
// compaction between them stay ordinary torch code).
//
// encode_scan_kernel.  Each lane (content b, way j) walks its way's state
// chain over the groups g = 0 .. G-1; ways never interact, so a content has
// W lanes of parallelism and G dependent steps.  The division by f is off
// the chain: the encoder owns a table of 16-byte records, one per (context,
// symbol), built once per model by rans_encode.py's encoder_table:
//   thr  = ~(xmax >> 1), xmax = min(f 2^(32-n), 2^32) - 1
//   mlo  = ceil(2^(32+s) / f) - 2^32   the 33-bit magic multiplier of
//                                      Granlund-Montgomery, s = ceil(log2 f)
//   bias = F
//   cs   = (2^n - f) << 5 | s          (the complement, signed, and s)
// and one step is
//   x1 = x > xmax ? x >> 16 : x                    (emits x & 0xFFFF)
//   q  = (x1 + umulhi(x1, mlo)) >> s               (33-bit sum: floor(x1/f))
//   x  = x1 + bias + q (2^n - f)
// which is the plain version's x1 + (x1 / f)(2^n - f) + F.  xmax is odd
// (its low 16 bits are ones), so x > xmax exactly when (x >> 1) + thr, as a
// signed 32-bit value, is >= 0: the step tests a sign and selects with a
// mask, and no predicate sits on the chain.  A symbol with f = 0 always
// renormalizes (thr = 0) and divides by 1 (mlo = s = 0, complement
// 2^n - 1); thr = 0 marks exactly those records, which set zero_freq.
// Each context has one more record, for out-of-alphabet symbols (f = 0,
// bias = F[c, 0]), and the table one more, for inactive slots (padding and
// resume lead slots: thr = -2^31, never renormalize; mlo = bias = cs = 0,
// so x passes through).
//
// The block is warp-specialized over 32 consecutive lanes t = b W + j, each
// warp on its own scheduler, with rings of kChunk-group stages in shared
// memory handed on by mbarriers:
//   warp 0, producer: copies each chunk's symbol, flag and (adaptive)
//       context rows into a raw ring with cp.async (16 bytes for four
//       lanes' symbols or contexts, 4 for their flags), kRaw - 1 chunks
//       ahead, one commit group a chunk.  Once a thread's copies of a
//       chunk have landed it turns those slots into their records' byte
//       offsets (the index arithmetic: context row, out-of-alphabet and
//       inactive slots) in the offset ring, and the warp arrives on the
//       stage's full barrier; a stage is refilled once the writer has
//       emptied it.
//   warp 1, chain: holds the 32 states.  A chunk's kChunk steps run
//       unrolled with no branch: each stores the pre-renormalization state
//       x into the stage, reads the record offset 2 kAhead steps ahead and
//       the record (from shared memory for a static model of at most
//       kSmemAlphabet symbols, else through __ldg) kAhead steps ahead, and
//       updates the state.  It waits for the next stage before a chunk's
//       first step, so the look-ahead runs on across the chunk's end.  The
//       last G mod kChunk groups run in a separate tail loop.
//   warp 2, writer: from the stage's x and the same record derives
//       word = x & 0xFFFF, mask = the step's renormalization (never on an
//       inactive slot) and y = mask ? x >> 16 : x, and stores four lanes'
//       words, masks and ys with one 8-, 4- and 16-byte store each.
// Four lanes' slots are contiguous and aligned when W is a multiple of 4
// and the tensors are 16-byte aligned, which the wrapper checks.
//
// What bounds it on the H100: the chain.  A step's state update is the
// sign test, its mask and the select, a multiply-high, the 33-bit sum's
// carry and shift and a multiply-add, each dependent on the one before;
// the bytes (4 B symbol, 1 B flag in; 2 B word, 1 B mask, 4 B y out per
// slot) are far below that at 3.35 TB/s.  The design leaves the chain warp
// little else to issue.
//
// The planner: three kernels, launched one after another on the caller's
// stream by rans_plan_splits, of which only the middle one is sequential.
// The greedy split slots of a content run in order (each slot depends on
// the c_prev and min_q of the one before).  For slot m:
//   T = ceil((N - c_prev) / (M - m)), target = c_prev + T (stop if >= N),
//   center = #emissions at symbols < target = csum[target - 1],
//   round 0 takes the candidates q in [max(min_q, center - w),
//   min(n_words - 1, center + w)] (stop if empty); each later round widens
//   the window by 2w a side, at most 8 rounds; the first round with a valid
//   candidate wins, ties going to the smallest q; a slot with no valid
//   candidate ends the planning of its content.
// A candidate's backward scan ("the last emission of way j at offset <= q")
// runs in symbol space: way j's last emitted symbol <= k_of_word[q] is
// k_j = last[t_j][j] W + j with t_j = floor((k_of_word[q] - j) / W), where
// last[g][j] is the last group <= g in which way j emitted (-1 before its
// first).  The candidate is valid when every way has such an emission and
// c = min_j k_j > c_prev, and scores h = |a - c_prev + 1 - T| +
// |c - c_prev - T| with a = max_j k_j.  Neither c nor a depends on the slot:
//   a(q) = k_of_word[q], since way (k_of_word[q] mod W) emitted word q;
//   c(q) < 0 exactly when some way has no emission at or below q (its k_j
//   is then negative), so "covered and c > c_prev" is c(q) > c_prev;
//   c(q) never decreases in q.
// So the W-way scan leaves the slot chain:
//   plan_cover_kernel (a), parallel over every word of every content:
//       c(q) = min over p in [kq - W + 1, kq] of last_flat[p] W + (p mod W)
//       (p itself for p < 0), kq = k_of_word[q]: the W entries t_j W + j
//       are the W consecutive flat symbols ending at kq.  One thread a
//       word; a warp's 32 windows overlap (about 2 symbols a word), so its
//       loads hit a few lines through L1.  Words past n_words get -1.
//   plan_chain_kernel (b), one warp per content: for each round's new
//       candidates the lanes read k_of_word[q] and c(q) over the contiguous
//       window, kCandidates a lane issued together, score them, and two
//       warp min-reductions (h, then q among the lanes holding that h) and
//       a shuffle of the winner's c pick the slot.  It writes found and q;
//       c_prev and min_q stay in registers; no block barrier.  So that a
//       slot's two dependent reads (the center, then its window) come from
//       shared memory, the lanes copy (cp.async) what the next slot will
//       most likely read into the other half of a double buffer while this
//       slot runs: csum around target + T - 1, and k_of_word and c around
//       the center extrapolated from this slot's and the last.  A read the
//       stage does not hold goes to global memory, so the guess decides
//       where a value is read, never which.  T's division uses a double
//       reciprocal computed a slot ahead.
//   plan_emit_kernel (c), one warp per found slot: k[slot][j] = g2 W + j and
//       y[slot][j] = ys[g2][j] with g2 = last[t_j][j] for the winner's q.
//
// What bounds it on the H100: the slot chain of (b), one warp issuing in
// order.  A slot is the division for T, the center read, its window's
// reads, the scoring of about 2w + 1 candidates (kCandidates a lane), two
// warp reductions and a shuffle, and the next stage's copies, each step
// dependent on the one before; the stage turns the two reads from global
// memory round trips into shared-memory reads.  The cover pass moves about
// last + k_of_word + c (on a 10 MB asset at n 11: 40 MB + 2 x 19 MB), tens
// of microseconds at 3.35 TB/s; the emit pass touches 2W entries a slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;             // lanes (content, way) of one block
constexpr int kChunk = 64;             // groups of one ring stage
constexpr int kStages = 4;             // stages of the offset and x rings
constexpr int kRaw = 3;                // stages of the raw ring
constexpr int kStage = kChunk * kLanes;
constexpr int kAhead = 2;              // records the chain loads ahead
constexpr int kEncodeThreads = 3 * 32;  // producer, chain and writer warps
constexpr int kSmemAlphabet = 4096;    // static tables staged in smem
constexpr int kCoverBlock = 256;       // words of one cover block
constexpr int kEmitBlock = 128;        // four slots of one emit block
// Candidates a chain lane loads at once: 7 x 32 covers a default round
// (2 x 96 + 1 candidates) in one batch.
constexpr int kCandidates = 7;
// Entries the chain's look-ahead stage holds of the csum row (around the
// next target) and of the k_of_word and cover rows (around the next
// center), each a multiple of 128.
constexpr int kLookCs = 256;
constexpr int kLookW = 512;
constexpr int kRounds = 8;             // the oracle's retry budget
constexpr unsigned kNoScore = ~0u;     // above any h (h <= 2^32 - 2)

// Shared memory of one encode block: the staged table (or none), the raw
// ring the producer copies into (symbols, contexts when adaptive, flags)
// and the rings it hands on (each slot's record offset, and the chain's
// pre-renormalization state).
struct EncodeSmem {
  uint4* table;
  int32_t* sym;
  int32_t* ctx;
  uint8_t* act;
  uint32_t* code;
  uint32_t* x;
};

template <bool ADAPTIVE>
constexpr size_t encode_smem_bytes(int n_table_records) {
  return static_cast<size_t>(n_table_records) * 16 +
         static_cast<size_t>(kRaw) * kStage * (ADAPTIVE ? 9 : 5) +
         static_cast<size_t>(kStages) * kStage * 8;
}

template <bool ADAPTIVE>
__device__ EncodeSmem encode_smem(unsigned char* base, int n_table_records) {
  EncodeSmem s;
  s.table = reinterpret_cast<uint4*>(base);
  s.code = reinterpret_cast<uint32_t*>(s.table + n_table_records);
  s.x = s.code + kStages * kStage;
  s.sym = reinterpret_cast<int32_t*>(s.x + kStages * kStage);
  s.ctx = s.sym + kRaw * kStage;
  s.act = reinterpret_cast<uint8_t*>(s.ctx + (ADAPTIVE ? kRaw * kStage : 0));
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Waits until the phase of ``bar`` with parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Whether state x renormalizes under a record whose first word is thr.
__device__ __forceinline__ bool renormalizes(uint32_t x, uint32_t thr) {
  return static_cast<int32_t>((x >> 1) + thr) >= 0;
}

// One encode step from the slot's record (thr, mlo, bias, cs).  The
// renormalization selects with a sign mask; the 33-bit sum x1 + umulhi(x1,
// mlo) and its shift are written in PTX (a multiply-high-add with carry
// out, the carry, a funnel shift), which ptxas keeps to four dependent
// instructions.
__device__ __forceinline__ uint32_t encode_step(uint32_t x, uint4 r) {
  const uint32_t keep = static_cast<uint32_t>(
      static_cast<int32_t>((x >> 1) + r.x) >> 31);   // ~0: no renormalization
  const uint32_t x1 = (x & keep) | ((x >> 16) & ~keep);
  uint32_t out;
  asm("{\n .reg .u32 lo, hi, q, c, b;\n"
      " mad.hi.cc.u32 lo, %1, %2, %1;\n"
      " addc.u32 hi, 0, 0;\n"
      " shf.r.wrap.b32 q, lo, hi, %4;\n"
      " shr.s32 c, %4, 5;\n"
      " add.u32 b, %1, %3;\n"
      " mad.lo.u32 %0, q, c, b;\n}"
      : "=r"(out)
      : "r"(x1), "r"(r.y), "r"(r.z), "r"(r.w));
  return out;
}

template <bool ADAPTIVE, bool SMEM_TABLE>
__global__ void __launch_bounds__(kEncodeThreads) encode_scan_kernel(
    const int32_t* __restrict__ sym, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ ctx, const uint4* __restrict__ table,
    int alphabet, int n_ctx, const uint32_t* __restrict__ x0, int n_lanes,
    int G, int W, uint16_t* __restrict__ words, uint8_t* __restrict__ masks,
    uint32_t* __restrict__ ys, uint32_t* __restrict__ final_states,
    int32_t* __restrict__ zero_freq) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kStages], xready[kStages], empty[kStages];
  const int inactive = n_ctx * (alphabet + 1);   // the last record
  const EncodeSmem s = encode_smem<ADAPTIVE>(
      smem, SMEM_TABLE ? inactive + 1 : 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&xready[i], 32);
      mbar_init(&empty[i], 32);
    }
  }
  if (SMEM_TABLE) {
    for (int i = threadIdx.x; i <= inactive; i += blockDim.x)
      s.table[i] = __ldg(table + i);
  }
  // The chain reads offsets a few rows past a chunk's last one (the next
  // stage's, or rows a short chunk leaves unwritten) and loads their
  // records; an offset the producer never wrote must still be a record's.
  for (int i = threadIdx.x; i < kStages * kStage; i += blockDim.x)
    s.code[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_full = G / kChunk, n_tail = G - n_full * kChunk;
  const int n_chunks = n_full + (n_tail > 0);
  // A slot's record, by its byte offset in the table.
  auto record = [&](uint32_t off) {
    return SMEM_TABLE
               ? *reinterpret_cast<const uint4*>(
                     reinterpret_cast<const unsigned char*>(s.table) + off)
               : __ldg(reinterpret_cast<const uint4*>(
                     reinterpret_cast<const unsigned char*>(table) + off));
  };

  if (warp == 1) {
    // The chain.  cd holds the record offsets of the next 2 kAhead steps
    // and r the records of the next kAhead, loaded across chunk ends: the
    // warp waits for the next stage before a chunk's first step, so the
    // chunk's last steps read it with no branch.  A step stores its x
    // first: shared memory loads keep their place after a store they might
    // alias, so the loads for later steps issue where they are written, as
    // soon as x is known, and not next to their use.
    const int t = blockIdx.x * kLanes + lane;
    uint32_t x = t < n_lanes ? x0[t] : 0u;
    uint32_t cd[2 * kAhead];
    uint4 r[kAhead];
    if (n_chunks > 0) {
      mbar_wait(&full[0], 0);
#pragma unroll
      for (int u = 0; u < 2 * kAhead; ++u) cd[u] = s.code[u * kLanes + lane];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) r[u] = record(cd[u]);
    }
    for (int k = 0; k < n_full; ++k) {
      const int at = (k % kStages) * kStage + lane;
      const int next = ((k + 1) % kStages) * kStage + lane;
      if (k + 1 < n_chunks)
        mbar_wait(&full[(k + 1) % kStages], ((k + 1) / kStages) & 1);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {   // u is a constant: no branch
        s.x[at + u * kLanes] = x;
        const uint4 cur = r[u % kAhead];
        const int u2 = u + 2 * kAhead;
        cd[u % (2 * kAhead)] = s.code[u2 < kChunk ? at + u2 * kLanes
                                                  : next + (u2 - kChunk) * kLanes];
        r[u % kAhead] = record(cd[(u + kAhead) % (2 * kAhead)]);
        x = encode_step(x, cur);
      }
      mbar_arrive(&xready[k % kStages]);
    }
    if (n_tail > 0) {   // its stage was waited for above
      const int k = n_full;
      const int at = (k % kStages) * kStage + lane;
#pragma unroll 1
      for (int u = 0; u < n_tail; ++u) {
        const int i = at + u * kLanes;
        s.x[i] = x;
        x = encode_step(x, record(s.code[i]));
      }
      mbar_arrive(&xready[k % kStages]);
    }
    if (t < n_lanes) final_states[t] = x;
    return;
  }

  // Producer and writer: each thread takes four lanes (a quad q, one
  // content's ways j .. j + 3) of rows r0, r0 + 4, ... of a chunk.
  const int q = lane & 7, r0 = lane >> 3;
  const int t = blockIdx.x * kLanes + 4 * q;
  const bool here = t < n_lanes;
  const int b = here ? t / W : 0;
  const int e0 = here ? b * G * W + (t - b * W) : 0;   // B G W < 2^31

  if (warp == 0) {
    // The producer: copies into the raw ring kRaw - 1 chunks ahead; once a
    // chunk's copies have landed, the record offset of each of its slots.
    auto copy = [&](int k) {
      if (k < n_chunks && here) {
        const int st = (k % kRaw) * kStage;
        const int rows = min(kChunk, G - k * kChunk);
        for (int r = r0; r < rows; r += 4) {
          const int e = e0 + (k * kChunk + r) * W;
          const int at = st + r * kLanes + 4 * q;
          cp_async16(s.sym + at, sym + e);
          cp_async4(s.act + at, active + e);
          if (ADAPTIVE) cp_async16(s.ctx + at, ctx + e);
        }
      }
      cp_async_commit();   // an empty group keeps the count in step
    };
    for (int k = 0; k < kRaw - 1; ++k) copy(k);
    for (int k = 0; k < n_chunks; ++k) {
      copy(k + kRaw - 1);
      cp_async_wait<kRaw - 1>();   // this thread's copies of chunk k
      const int st = k % kStages;
      if (k >= kStages) mbar_wait(&empty[st], ((k / kStages) - 1) & 1);
      const int rows = min(kChunk, G - k * kChunk);
#pragma unroll 4
      for (int r = r0; r < rows; r += 4) {
        const int raw = (k % kRaw) * kStage + r * kLanes + 4 * q;
        const int4 sv = *reinterpret_cast<const int4*>(s.sym + raw);
        const uint32_t av = *reinterpret_cast<const uint32_t*>(s.act + raw);
        const int4 cv = ADAPTIVE ? *reinterpret_cast<const int4*>(s.ctx + raw)
                                 : make_int4(0, 0, 0, 0);
        const int sy[4] = {sv.x, sv.y, sv.z, sv.w};
        const int cx[4] = {cv.x, cv.y, cv.z, cv.w};
        uint32_t off[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // Symbols outside the alphabet take their context's last record,
          // inactive slots (and lanes past the last content) the table's.
          const int row =
              ADAPTIVE ? min(max(cx[v], 0), n_ctx - 1) * (alphabet + 1) : 0;
          const int sc = static_cast<int>(min(static_cast<uint32_t>(sy[v]),
                                              static_cast<uint32_t>(alphabet)));
          const bool act = here && ((av >> (8 * v)) & 0xFFu) != 0u;
          off[v] = static_cast<uint32_t>(act ? row + sc : inactive) *
                   sizeof(uint4);
        }
        *reinterpret_cast<uint4*>(s.code + st * kStage + r * kLanes + 4 * q) =
            make_uint4(off[0], off[1], off[2], off[3]);
      }
      mbar_arrive(&full[st]);
    }
    cp_async_wait<0>();
    return;
  }

  // The writer.
  bool bad = false;
  for (int k = 0; k < n_chunks; ++k) {
    const int st = k % kStages;
    const uint32_t parity = (k / kStages) & 1;
    mbar_wait(&full[st], parity);
    mbar_wait(&xready[st], parity);
    const int rows = min(kChunk, G - k * kChunk);
    if (here) {
      for (int r = r0; r < rows; r += 4) {
        const int at = st * kStage + r * kLanes + 4 * q;
        const uint4 xv = *reinterpret_cast<const uint4*>(s.x + at);
        const uint4 cv = *reinterpret_cast<const uint4*>(s.code + at);
        const uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
        const uint32_t c[4] = {cv.x, cv.y, cv.z, cv.w};
        uint32_t y[4], m = 0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint32_t thr = record(c[v]).x;
          const bool emit = renormalizes(x[v], thr);
          bad |= thr == 0u;
          y[v] = emit ? x[v] >> 16 : x[v];
          m |= static_cast<uint32_t>(emit) << (8 * v);
        }
        const int e = e0 + (k * kChunk + r) * W;
        *reinterpret_cast<uint2*>(words + e) =
            make_uint2(__byte_perm(x[0], x[1], 0x5410),
                       __byte_perm(x[2], x[3], 0x5410));
        *reinterpret_cast<uint32_t*>(masks + e) = m;
        *reinterpret_cast<uint4*>(ys + e) = make_uint4(y[0], y[1], y[2], y[3]);
      }
    }
    mbar_arrive(&empty[st]);
  }
  if (here && bad) zero_freq[b] = 1;   // every writer stores the same value
}

// (a) c(q) for every word q < cap of content b (rows b = blockIdx.y,
// blockIdx.y + gridDim.y, ...); -1 past n_words[b].
__global__ void __launch_bounds__(kCoverBlock) plan_cover_kernel(
    const int32_t* __restrict__ k_of_word, int cap,
    const int32_t* __restrict__ last, const int32_t* __restrict__ n_words,
    int n_contents, int G, int W, int32_t* __restrict__ cover) {
  const int q = blockIdx.x * kCoverBlock + threadIdx.x;
  if (q >= cap) return;
  for (int b = blockIdx.y; b < n_contents; b += gridDim.y) {
    const size_t at = static_cast<size_t>(b) * cap + q;
    int c = -1;
    if (q < n_words[b]) {
      const int kq = k_of_word[at];
      const int32_t* lst = last + static_cast<size_t>(b) * G * W;
      // The window's first symbol p = kq - W + 1 is way (kq + 1) mod W.
      int p = kq - W + 1, j = (kq + 1) % W;
      c = 0x7fffffff;
#pragma unroll 8
      for (int i = 0; i < W; ++i, ++p) {
        const int k = p >= 0 ? __ldg(lst + p) * W + j : p;
        c = min(c, k);
        j = j + 1 == W ? 0 : j + 1;
      }
    }
    cover[at] = c;
  }
}

// Copies the N entries at ``src`` (16-byte aligned) into ``dst``, 16 bytes
// a lane at a time; they land by the warp's next cp_async_wait.
template <int N>
__device__ __forceinline__ void stage_copy(int32_t* dst, const int32_t* src,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < N / (4 * 32); ++k)
    cp_async16(dst + 4 * (lane + 32 * k), src + 4 * (lane + 32 * k));
}

// The first entry of an N-entry look-ahead stage centred on entry ``mid``
// of a row of ``len`` >= N entries at ``row``: clamped into the row, then
// moved down to a 16-byte boundary (by at most 3 entries, which lie in the
// row before: a first row starts at the tensor's aligned base).
template <int N>
__device__ __forceinline__ int stage_start(unsigned mid, int len,
                                           const int32_t* row) {
  const unsigned s = min(mid > N / 2 ? mid - N / 2 : 0u,
                         static_cast<unsigned>(len - N));
  return static_cast<int>(s) -
         static_cast<int>((reinterpret_cast<uintptr_t>(row + s) & 15u) >> 2);
}

// A lane's best candidate so far: the least (h, q), and its c.
struct Best {
  unsigned h;
  int q, c;
};

// Scores the candidates q in [qa, qb] that fall to this lane (q = qa +
// 32 k + lane), kCandidates loaded at a time from ``kw`` and ``cv`` at
// q - at (shared memory when STAGE, through the read-only cache
// otherwise), into ``best``.  A candidate is valid when c > c_prev and
// scores h = |k_of_word - c_prev + 1 - T| + |c - c_prev - T|; each term is
// below 2^31, so their sum fits 32 unsigned bits.  A lane meets its
// candidates in ascending q, so a tie keeps the first.
template <bool STAGE>
__device__ __forceinline__ void score_range(const int32_t* kw,
                                            const int32_t* cv, int at, int qa,
                                            int qb, int c_prev, int T,
                                            Best& best) {
  const int lane = threadIdx.x & 31;
  for (int base = qa; base <= qb; base += 32 * kCandidates) {
    int kq[kCandidates], c[kCandidates];
#pragma unroll
    for (int u = 0; u < kCandidates; ++u) {
      const int q = base + 32 * u + lane;
      kq[u] = 0;
      c[u] = -1;
      if (q <= qb) {
        kq[u] = STAGE ? kw[q - at] : __ldg(kw + q);
        c[u] = STAGE ? cv[q - at] : __ldg(cv + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kCandidates; ++u) {
      const unsigned h = static_cast<unsigned>(abs(kq[u] - c_prev + 1 - T)) +
                         static_cast<unsigned>(abs(c[u] - c_prev - T));
      if (c[u] > c_prev && h < best.h) best = {h, base + 32 * u + lane, c[u]};
    }
  }
}

// (b) The slot chain of content blockIdx.x, one warp (see the header):
// writes found[slot] and q[slot] for the slots it fills.  Rows shorter than
// a stage are read from global memory alone.
__global__ void __launch_bounds__(32) plan_chain_kernel(
    const int32_t* __restrict__ k_of_word, const int32_t* __restrict__ cover,
    int cap, const int32_t* __restrict__ csum,
    const int32_t* __restrict__ n_words, const int32_t* __restrict__ n_symbols,
    const int32_t* __restrict__ n_splits, int G, int W, int n_slots,
    int window, uint8_t* __restrict__ found, int32_t* __restrict__ q_out) {
  __shared__ __align__(16) int32_t s_cs[2][kLookCs];
  __shared__ __align__(16) int32_t s_kw[2][kLookW];
  __shared__ __align__(16) int32_t s_cv[2][kLookW];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int NW = n_words[b], N = n_symbols[b], M = n_splits[b];
  if (M <= 1 || NW == 0 || N <= 0) return;
  const int n_grid = G * W;
  const int32_t* kw = k_of_word + static_cast<size_t>(b) * cap;
  const int32_t* cv = cover + static_cast<size_t>(b) * cap;
  const int32_t* cs = csum + static_cast<size_t>(b) * n_grid;
  const bool staged = cap >= kLookW && n_grid >= kLookCs;

  // The stage this slot reads: cur, and its first entries in the csum row
  // (at_cs) and in the k_of_word and cover rows (at_w); have: it holds
  // data.  The stage copied last (nx, at nx_cs and nx_w) is in flight until
  // the next slot waits for it.
  int cur = 0, at_cs = 0, at_w = 0, nx = 0, nx_cs = 0, nx_w = 0;
  bool have = false, in_flight = false;
  int c_prev = 0, min_q = 0, prev_center = 0;
  double rcp = 1.0 / M;
  for (int m = 0; m < M - 1 && m < n_slots; ++m) {
    const int denom = M - m;
    // T = ceil((N - c_prev) / denom).  The reciprocal's quotient is exact,
    // or one short when the true quotient is an integer; the test repairs
    // that.
    const int num = N - c_prev + denom - 1;
    int T = __double2int_rz(static_cast<double>(num) * rcp);
    T += static_cast<long long>(T + 1) * denom <= num;
    rcp = 1.0 / (denom - 1);   // the next slot's, off this slot's chain
    const int target = c_prev + T;
    if (target >= N) break;
    if (in_flight) {   // nx == cur
      cp_async_wait<0>();
      __syncwarp();
      in_flight = false;
      have = true;
      at_cs = nx_cs;
      at_w = nx_w;
    }
    const unsigned ci = static_cast<unsigned>(target - 1 - at_cs);
    const int center =
        have && ci < kLookCs ? s_cs[cur][ci] : __ldg(cs + target - 1);
    if (staged) {
      // The next slot's stage, centred on target + T - 1 and on
      // 2 center - prev_center (centers never decrease), each below 2^32.
      // Its previous contents were all read by the slot before this one.
      nx = cur ^ 1;
      nx_cs = stage_start<kLookCs>(static_cast<unsigned>(target) + T - 1,
                                   n_grid, cs);
      nx_w = stage_start<kLookW>(
          static_cast<unsigned>(center) + (center - prev_center), cap, kw);
      stage_copy<kLookCs>(s_cs[nx], cs + nx_cs, lane);
      stage_copy<kLookW>(s_kw[nx], kw + nx_w, lane);
      stage_copy<kLookW>(s_cv[nx], cv + nx_w, lane);
      cp_async_commit();
      in_flight = true;
    }
    prev_center = center;
    int lo = max(min_q, center - window), hi = min(NW - 1, center + window);
    bool got = false;
    if (hi >= lo) {
      int p_lo = hi + 1, p_hi = hi;   // the previous round's window (none)
      for (int r = 0; r < kRounds && !got; ++r) {
        // The candidates this round adds, in ascending q: [lo, p_lo - 1]
        // and [p_hi + 1, hi].  The round reads them from the stage if it
        // holds them all: one branch for the warp, so that its loads go to
        // one memory only.
        const bool from_stage = have && lo >= at_w && hi < at_w + kLookW;
        Best best = {kNoScore, 0, 0};
        auto score = [&](int qa, int qb) {
          if (from_stage)
            score_range<true>(s_kw[cur], s_cv[cur], at_w, qa, qb, c_prev, T,
                              best);
          else
            score_range<false>(kw, cv, 0, qa, qb, c_prev, T, best);
        };
        score(lo, min(p_lo - 1, hi));
        score(max(p_hi + 1, lo), hi);
        const unsigned h_min = __reduce_min_sync(0xffffffffu, best.h);
        if (h_min != kNoScore) {
          const bool mine = best.h == h_min;
          const unsigned q_min = __reduce_min_sync(
              0xffffffffu, mine ? static_cast<unsigned>(best.q) : ~0u);
          const unsigned at = __ballot_sync(
              0xffffffffu, mine && static_cast<unsigned>(best.q) == q_min);
          c_prev = __shfl_sync(0xffffffffu, best.c, __ffs(at) - 1);
          min_q = static_cast<int>(q_min) + 1;
          if (lane == 0) {
            const size_t slot = static_cast<size_t>(b) * n_slots + m;
            found[slot] = 1;
            q_out[slot] = static_cast<int>(q_min);
          }
          got = true;
        }
        p_lo = lo;
        p_hi = hi;
        lo = max(min_q, lo - 2 * window);
        hi = min(NW - 1, hi + 2 * window);
      }
    }
    if (!got) break;
    cur = nx;
  }
  // A stage still being copied lands before the block's shared memory is
  // released.
  cp_async_wait<0>();
}

// (c) Each found slot's k[W] and y[W], one warp a slot.
__global__ void __launch_bounds__(kEmitBlock) plan_emit_kernel(
    const int32_t* __restrict__ k_of_word, int cap,
    const int32_t* __restrict__ last, const uint32_t* __restrict__ ys,
    const uint8_t* __restrict__ found, const int32_t* __restrict__ q_in,
    int n_rows, int G, int W, int n_slots, int32_t* __restrict__ k_out,
    uint32_t* __restrict__ y_out) {
  const int row = blockIdx.x * (kEmitBlock / 32) + (threadIdx.x >> 5);
  if (row >= n_rows || !found[row]) return;
  const int b = row / n_slots;
  const size_t grid = static_cast<size_t>(G) * W;
  const int32_t* lst = last + b * grid;
  const uint32_t* yy = ys + b * grid;
  const int kq = k_of_word[static_cast<size_t>(b) * cap + q_in[row]];
  const int t0 = kq / W, r0 = kq - t0 * W;
  for (int j = threadIdx.x & 31; j < W; j += 32) {
    const int t = j <= r0 ? t0 : t0 - 1;
    const int g2 = lst[static_cast<size_t>(t) * W + j];
    k_out[static_cast<size_t>(row) * W + j] = g2 * W + j;
    y_out[static_cast<size_t>(row) * W + j] = yy[static_cast<size_t>(g2) * W + j];
  }
}

int launch_cover(const int32_t* k_of_word, int cap, const int32_t* last,
                 const int32_t* n_words, int n_contents, int G, int W,
                 int32_t* cover, cudaStream_t st) {
  const dim3 grid((cap + kCoverBlock - 1) / kCoverBlock,
                  n_contents < 65535 ? n_contents : 65535);
  plan_cover_kernel<<<grid, kCoverBlock, 0, st>>>(
      k_of_word, cap, last, n_words, n_contents, G, W, cover);
  return static_cast<int>(cudaGetLastError());
}

template <bool ADAPTIVE, bool SMEM_TABLE>
int launch_encode(const int32_t* sym, const uint8_t* active,
                  const int32_t* ctx, const uint4* table, int alphabet,
                  int n_ctx, const uint32_t* x0, int n_lanes, int G, int W,
                  uint16_t* words, uint8_t* masks, uint32_t* ys,
                  uint32_t* final_states, int32_t* zero_freq,
                  cudaStream_t st) {
  // Past 48 KB a block's dynamic shared memory needs the kernel's opt-in,
  // set once per process to the most any launch of it asks for.
  static const cudaError_t opt_in = [] {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_scan_kernel<ADAPTIVE, SMEM_TABLE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(encode_smem_bytes<ADAPTIVE>(
            SMEM_TABLE ? kSmemAlphabet + 2 : 0)));
    if (err != cudaSuccess) cudaGetLastError();   // returned, not left set
    return err;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int n_records = n_ctx * (alphabet + 1) + 1;
  const int blocks = (n_lanes + kLanes - 1) / kLanes;
  encode_scan_kernel<ADAPTIVE, SMEM_TABLE>
      <<<blocks, kEncodeThreads,
         encode_smem_bytes<ADAPTIVE>(SMEM_TABLE ? n_records : 0), st>>>(
          sym, active, ctx, table, alphabet, n_ctx, x0, n_lanes, G, W, words,
          masks, ys, final_states, zero_freq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers, bound from Python with ctypes.  Every pointer is a
// device pointer; u32 values travel as their bit patterns.  Each returns
// cudaGetLastError() after its launch (0 = launched), or the error that
// kept it from launching.

// sym, active, ctx: [B, G, W] (ctx == nullptr for a static model), W a
// multiple of 4, 16-byte aligned; table: the encoder records, n_ctx
// (alphabet + 1) + 1 of them (encoder_table's records, int32
// [n_ctx * (alphabet + 1) + 1, 4]); x0, final_states [B, W];
// words, masks, ys [B, G, W]; zero_freq [B], zeroed by the caller.  A
// static table of at most 4096 symbols is staged in shared memory, any
// other is read through the read-only data cache.
extern "C" int rans_encode_scan(
    const void* sym, const void* active, const void* ctx, const void* table,
    int alphabet, int n_ctx, const void* x0, int n_contents, int G, int W,
    void* words, void* masks, void* ys, void* final_states, void* zero_freq,
    void* cuda_stream) {
  const auto* s = static_cast<const int32_t*>(sym);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* c = static_cast<const int32_t*>(ctx);
  const auto* tab = static_cast<const uint4*>(table);
  const auto* x = static_cast<const uint32_t*>(x0);
  auto* w = static_cast<uint16_t*>(words);
  auto* m = static_cast<uint8_t*>(masks);
  auto* y = static_cast<uint32_t*>(ys);
  auto* fs = static_cast<uint32_t*>(final_states);
  auto* zf = static_cast<int32_t*>(zero_freq);
  auto st = static_cast<cudaStream_t>(cuda_stream);
  const int lanes = n_contents * W;
  if (c != nullptr)
    return launch_encode<true, false>(s, a, c, tab, alphabet, n_ctx, x, lanes,
                                      G, W, w, m, y, fs, zf, st);
  if (alphabet <= kSmemAlphabet)
    return launch_encode<false, true>(s, a, c, tab, alphabet, 1, x, lanes, G,
                                      W, w, m, y, fs, zf, st);
  return launch_encode<false, false>(s, a, c, tab, alphabet, 1, x, lanes, G,
                                     W, w, m, y, fs, zf, st);
}

// k_of_word [B, cap]; last [B, G, W]; n_words [B]; cover [B, cap], the
// output: c(q) of each word, -1 past n_words.  The planner's step (a) alone.
extern "C" int rans_plan_cover(const void* k_of_word, int cap,
                               const void* last, const void* n_words,
                               int n_contents, int G, int W, void* cover,
                               void* cuda_stream) {
  return launch_cover(static_cast<const int32_t*>(k_of_word), cap,
                      static_cast<const int32_t*>(last),
                      static_cast<const int32_t*>(n_words), n_contents, G, W,
                      static_cast<int32_t*>(cover),
                      static_cast<cudaStream_t>(cuda_stream));
}

// k_of_word [B, cap]; csum [B, G * W]; last, ys [B, G, W]; n_words,
// n_symbols, n_splits [B]; outputs found [B, S], q [B, S], k, y [B, S, W]
// for S = n_slots, zeroed (q: -1) by the caller; cover [B, cap], scratch.
// Launches the cover, chain and emit kernels in turn and returns the first
// launch error.
extern "C" int rans_plan_splits(
    const void* k_of_word, int cap, const void* csum, const void* last,
    const void* ys, const void* n_words, const void* n_symbols,
    const void* n_splits, int n_contents, int G, int W, int n_slots,
    int window, void* found, void* q, void* k, void* y, void* cover,
    void* cuda_stream) {
  const auto* kw = static_cast<const int32_t*>(k_of_word);
  const auto* lst = static_cast<const int32_t*>(last);
  const auto* nw = static_cast<const int32_t*>(n_words);
  auto* cv = static_cast<int32_t*>(cover);
  auto* fd = static_cast<uint8_t*>(found);
  auto* qq = static_cast<int32_t*>(q);
  auto st = static_cast<cudaStream_t>(cuda_stream);
  int err = launch_cover(kw, cap, lst, nw, n_contents, G, W, cv, st);
  if (err != 0) return err;
  plan_chain_kernel<<<n_contents, 32, 0, st>>>(
      kw, cv, cap, static_cast<const int32_t*>(csum), nw,
      static_cast<const int32_t*>(n_symbols),
      static_cast<const int32_t*>(n_splits), G, W, n_slots, window, fd, qq);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows = n_contents * n_slots;
  plan_emit_kernel<<<(rows + kEmitBlock / 32 - 1) / (kEmitBlock / 32),
                     kEmitBlock, 0, st>>>(
      kw, cap, lst, static_cast<const uint32_t*>(ys), fd, qq, rows, G, W,
      n_slots, static_cast<int32_t*>(k), static_cast<uint32_t*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

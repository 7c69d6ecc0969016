// Recoil ingest for NVIDIA Hopper (sm_90a): the W-way interleaved rANS
// encode and the Definition-4.1 split planner.
//
// The JAX package runs both as lax.scan loops that XLA compiles into one
// sequential device loop each; there is no Pallas kernel for them.  These
// kernels replace
//   encode_scan_kernel <- src/repro/core/encode/ops.py  encode_scan
//   plan_splits_kernel <- src/repro/core/encode/ops.py  plan_split_scan
// and compute exactly what those functions compute (the emission layout and
// compaction between them stay ordinary torch code).
//
// encode_scan_kernel.  One thread per (content, way j); the thread walks its
// way's state chain over the groups g = 0 .. G-1 with the u32 state in a
// register:
//   renorm = active && (x >> (32 - n)) >= f
//   x1     = renorm ? x >> 16 : x            (emits the word x & 0xFFFF)
//   x      = active ? ((x1 / f) << n) + F + x1 % f : x1
// and writes the group's word, emit mask and bounded state y = x1 in the
// (content, group, way) grid the compaction reads.  Ways never interact, so
// a content has W threads of parallelism and G dependent steps.  The static
// model's (f, F) table (alphabet <= 4096) is staged in shared memory; an
// adaptive model's [C, A] tables and larger alphabets are read through the
// read-only data cache.  Symbols, active flags and context ids do not depend
// on the state, so each thread loads them 8 groups ahead of its chain.
// Inactive lanes (padding and resume lead slots) and out-of-alphabet
// symbols divide by max(f, 1); an active symbol with f == 0, or outside the
// alphabet, sets the content's zero_freq flag.
//
// What bounds it on the H100: the chain.  Each step's state update is a
// compare, a select, a 32-bit division and a multiply-add, each dependent
// on the one before and the first on the previous step's state, so a
// content takes at least G times that chain's dependent latency; the bytes
// (4 B symbol, 1 B flag in; 2 B word, 1 B mask, 4 B y out per symbol) are
// far below that at 3.35 TB/s.  The design keeps the chain free of memory latency (the loads
// run ahead, the table sits in shared memory, the stores are not waited on).
//
// plan_splits_kernel.  One block per content; the block runs the greedy
// split slots in order (each slot depends on the c_prev and min_q of the one
// before).  For slot m:
//   T = ceil((N - c_prev) / (M - m)), target = c_prev + T (stop if >= N),
//   center = #emissions at symbols < target = csum[target - 1],
//   round 0 takes the candidates q in [max(min_q, center - w),
//   min(n_words - 1, center + w)] (stop if empty); each later round widens
//   the window by 2w a side, at most 8 rounds; the first round with a valid
//   candidate wins, ties going to the smallest q; a slot with no valid
//   candidate ends the planning of its content.
// Rounds are evaluated lazily: a round evaluates only the candidates its
// window adds (those of earlier rounds were all invalid).  The block's
// threads take one candidate each and evaluate the backward scan "the last
// emission of way j at offset <= q" in symbol space: it is way j's last
// emitted symbol <= k_of_word[q], i.e. group last[t][j] with
// t = floor((k_of_word[q] - j) / W), where last[g][j] is the last group
// <= g in which way j emitted (-1 before its first).  A candidate is valid
// when every way has such an emission and c = min_j k_j > c_prev; it scores
// h = |a - c_prev + 1 - T| + |c - c_prev - T| (a = max_j k_j).  A block
// minimum over the key (h << 32 | q) picks the winner, and the block writes
// its k[W] and y[W].
//
// What bounds it: the slot chain.  Every slot waits for the previous slot's
// winner, and inside a slot the center lookup, the candidate's k_of_word
// read, its last[] reads and the block reduction are dependent.  The
// metadata written and the tables read are a few megabytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEncodeBlock = 128;
constexpr int kAhead = 8;              // groups loaded ahead of the chain
constexpr int kSmemAlphabet = 4096;    // (f, F) pairs staged: 32 KB
constexpr int kPlanBlock = 256;
constexpr int kRounds = 8;             // the oracle's retry budget
constexpr unsigned long long kNone = ~0ull;

template <bool ADAPTIVE, bool SMEM_TABLE>
__global__ void __launch_bounds__(kEncodeBlock) encode_scan_kernel(
    const int32_t* __restrict__ sym, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ ctx, const int32_t* __restrict__ f_tab,
    const int32_t* __restrict__ F_tab, int alphabet, int n_ctx,
    int F_stride, const uint32_t* __restrict__ x0, int n_lanes, int G,
    int W, int n_bits, uint16_t* __restrict__ words,
    uint8_t* __restrict__ masks, uint32_t* __restrict__ ys,
    uint32_t* __restrict__ final_states, int32_t* __restrict__ zero_freq) {
  extern __shared__ int2 s_tab[];
  if (SMEM_TABLE) {
    for (int i = threadIdx.x; i < alphabet; i += blockDim.x)
      s_tab[i] = make_int2(f_tab[i], F_tab[i]);
    __syncthreads();
  }
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int b = t / W;
  const size_t base = static_cast<size_t>(b) * G * W + (t - b * W);
  const uint32_t shift = 32u - n_bits;
  uint32_t x = x0[t];
  bool bad = false;

  int s_nxt[kAhead], c_nxt[kAhead];
  uint8_t a_nxt[kAhead];
  auto load = [&](int g0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int g = g0 + u;
      const size_t idx = base + static_cast<size_t>(g) * W;
      const bool in = g < G;
      s_nxt[u] = in ? sym[idx] : 0;
      a_nxt[u] = in ? active[idx] : 0;
      c_nxt[u] = (ADAPTIVE && in) ? ctx[idx] : 0;
    }
  };
  load(0);
#pragma unroll 1
  for (int g0 = 0; g0 < G; g0 += kAhead) {
    int s_cur[kAhead], c_cur[kAhead];
    uint8_t a_cur[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      s_cur[u] = s_nxt[u];
      a_cur[u] = a_nxt[u];
      c_cur[u] = c_nxt[u];
    }
    if (g0 + kAhead < G) load(g0 + kAhead);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int g = g0 + u;
      if (g >= G) break;
      const size_t idx = base + static_cast<size_t>(g) * W;
      const int s = s_cur[u];
      const bool act = a_cur[u] != 0;
      const bool in_alpha = static_cast<unsigned>(s) <
                            static_cast<unsigned>(alphabet);
      const int sc = in_alpha ? s : 0;
      uint32_t f, F;
      if (ADAPTIVE) {
        const int c = min(max(c_cur[u], 0), n_ctx - 1);
        f = __ldg(f_tab + static_cast<size_t>(c) * alphabet + sc);
        F = __ldg(F_tab + static_cast<size_t>(c) * F_stride + sc);
      } else if (SMEM_TABLE) {
        const int2 e = s_tab[sc];
        f = e.x;
        F = e.y;
      } else {
        f = __ldg(f_tab + sc);
        F = __ldg(F_tab + sc);
      }
      if (!in_alpha) f = 0;
      bad |= act && f == 0;
      const bool renorm = act && (x >> shift) >= f;
      const uint32_t x1 = renorm ? x >> 16 : x;
      const uint32_t fd = f > 1u ? f : 1u;
      const uint32_t q = x1 / fd;
      const uint32_t enc = (q << n_bits) + F + (x1 - q * fd);
      words[idx] = static_cast<uint16_t>(x & 0xFFFFu);
      masks[idx] = renorm;
      ys[idx] = x1;
      x = act ? enc : x1;
    }
  }
  final_states[t] = x;
  if (bad) zero_freq[b] = 1;   // every writer stores the same value
}

// Block-wide minimum of a 64-bit key; every thread returns it.
__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* s_warp,
                                        unsigned long long* s_out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? s_warp[lane] : kNone;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
      v = w < v ? w : v;
    }
    if (lane == 0) *s_out = v;
  }
  __syncthreads();
  return *s_out;
}

__global__ void __launch_bounds__(kPlanBlock) plan_splits_kernel(
    const int32_t* __restrict__ k_of_word, int cap,
    const int32_t* __restrict__ csum, const int32_t* __restrict__ last,
    const uint32_t* __restrict__ ys, const int32_t* __restrict__ n_words,
    const int32_t* __restrict__ n_symbols,
    const int32_t* __restrict__ n_splits, int G, int W, int n_slots,
    int window, uint8_t* __restrict__ found, int32_t* __restrict__ q_out,
    int32_t* __restrict__ k_out, uint32_t* __restrict__ y_out) {
  __shared__ unsigned long long s_warp[kPlanBlock / 32];
  __shared__ unsigned long long s_best;
  __shared__ int s_c;
  const int b = blockIdx.x;
  const int NW = n_words[b], N = n_symbols[b], M = n_splits[b];
  if (M <= 1 || NW == 0 || N <= 0) return;
  const size_t grid = static_cast<size_t>(G) * W;
  const int32_t* kw = k_of_word + static_cast<size_t>(b) * cap;
  const int32_t* cs = csum + b * grid;
  const int32_t* lst = last + b * grid;
  const uint32_t* yy = ys + b * grid;

  int c_prev = 0, min_q = 0;
  for (int m = 0; m < M - 1 && m < n_slots; ++m) {
    const int denom = M - m;
    const int T = (N - c_prev + denom - 1) / denom;
    const int target = c_prev + T;
    if (target >= N) break;
    const int center = cs[target - 1];
    int lo = max(min_q, center - window), hi = min(NW - 1, center + window);
    if (hi < lo) break;
    int p_lo = hi + 1, p_hi = hi;   // the previous round's window (none)
    bool got = false;
    for (int r = 0; r < kRounds && !got; ++r) {
      // The candidates this round adds: [lo, p_lo - 1] and [p_hi + 1, hi].
      const int n_a = max(0, min(p_lo - 1, hi) - lo + 1);
      const int b0 = max(p_hi + 1, lo);
      const int n_new = n_a + max(0, hi - b0 + 1);
      unsigned long long mine = kNone;
      int mine_c = 0;
      for (int i = threadIdx.x; i < n_new; i += blockDim.x) {
        const int q = i < n_a ? lo + i : b0 + (i - n_a);
        const int kq = kw[q];
        const int t0 = kq / W, r0 = kq - t0 * W;
        int c = 0x7fffffff, a = -1;
        bool ok = true;
        for (int j = 0; j < W && ok; ++j) {
          const int t = j <= r0 ? t0 : t0 - 1;
          const int g2 = t >= 0 ? lst[static_cast<size_t>(t) * W + j] : -1;
          ok = g2 >= 0;
          const int k = g2 * W + j;
          c = min(c, k);
          a = max(a, k);
        }
        if (ok && c > c_prev) {
          const unsigned h = abs(a - c_prev + 1 - T) + abs(c - c_prev - T);
          const unsigned long long key =
              (static_cast<unsigned long long>(h) << 32) |
              static_cast<unsigned>(q);
          if (key < mine) {
            mine = key;
            mine_c = c;
          }
        }
      }
      const unsigned long long best = block_min(mine, s_warp, &s_best);
      if (best != kNone) {
        if (mine == best) s_c = mine_c;   // q is unique to one thread
        __syncthreads();
        const int qb = static_cast<int>(best & 0xffffffffu);
        const int kq = kw[qb];
        const int t0 = kq / W, r0 = kq - t0 * W;
        const size_t slot = static_cast<size_t>(b) * n_slots + m;
        for (int j = threadIdx.x; j < W; j += blockDim.x) {
          const int t = j <= r0 ? t0 : t0 - 1;
          const int g2 = lst[static_cast<size_t>(t) * W + j];
          k_out[slot * W + j] = g2 * W + j;
          y_out[slot * W + j] = yy[static_cast<size_t>(g2) * W + j];
        }
        if (threadIdx.x == 0) {
          found[slot] = 1;
          q_out[slot] = qb;
        }
        c_prev = s_c;
        min_q = qb + 1;
        got = true;
      }
      __syncthreads();   // s_best and s_c are written again next round
      p_lo = lo;
      p_hi = hi;
      lo = max(min_q, lo - 2 * window);
      hi = min(NW - 1, hi + 2 * window);
    }
    if (!got) break;
  }
}

template <bool ADAPTIVE, bool SMEM_TABLE>
void launch_encode(const int32_t* sym, const uint8_t* active,
                   const int32_t* ctx, const int32_t* f_tab,
                   const int32_t* F_tab, int alphabet, int n_ctx,
                   int F_stride, const uint32_t* x0, int n_lanes, int G,
                   int W, int n_bits, uint16_t* words, uint8_t* masks,
                   uint32_t* ys, uint32_t* final_states, int32_t* zero_freq,
                   cudaStream_t st) {
  const int blocks = (n_lanes + kEncodeBlock - 1) / kEncodeBlock;
  const size_t smem = SMEM_TABLE ? alphabet * sizeof(int2) : 0;
  encode_scan_kernel<ADAPTIVE, SMEM_TABLE><<<blocks, kEncodeBlock, smem, st>>>(
      sym, active, ctx, f_tab, F_tab, alphabet, n_ctx, F_stride, x0, n_lanes,
      G, W, n_bits, words, masks, ys, final_states, zero_freq);
}

}  // namespace

// Plain C launchers, bound from Python with ctypes.  Every pointer is a
// device pointer; u32 values travel as their bit patterns.  Each returns
// cudaGetLastError() after its launch (0 = launched).

// sym, active, ctx: [B, G, W] (ctx == nullptr for a static model);
// f_tab [A] or [C, A], F_tab rows of F_stride entries; x0, final_states
// [B, W]; words, masks, ys [B, G, W]; zero_freq [B], zeroed by the caller.
extern "C" int rans_encode_scan(
    const void* sym, const void* active, const void* ctx, const void* f_tab,
    const void* F_tab, int alphabet, int n_ctx, int F_stride, const void* x0,
    int n_contents, int G, int W, int n_bits, void* words, void* masks,
    void* ys, void* final_states, void* zero_freq, void* cuda_stream) {
  const auto* s = static_cast<const int32_t*>(sym);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* c = static_cast<const int32_t*>(ctx);
  const auto* f = static_cast<const int32_t*>(f_tab);
  const auto* F = static_cast<const int32_t*>(F_tab);
  const auto* x = static_cast<const uint32_t*>(x0);
  auto* w = static_cast<uint16_t*>(words);
  auto* m = static_cast<uint8_t*>(masks);
  auto* y = static_cast<uint32_t*>(ys);
  auto* fs = static_cast<uint32_t*>(final_states);
  auto* zf = static_cast<int32_t*>(zero_freq);
  auto st = static_cast<cudaStream_t>(cuda_stream);
  const int lanes = n_contents * W;
  if (c != nullptr)
    launch_encode<true, false>(s, a, c, f, F, alphabet, n_ctx, F_stride, x,
                               lanes, G, W, n_bits, w, m, y, fs, zf, st);
  else if (alphabet <= kSmemAlphabet)
    launch_encode<false, true>(s, a, c, f, F, alphabet, 1, F_stride, x,
                               lanes, G, W, n_bits, w, m, y, fs, zf, st);
  else
    launch_encode<false, false>(s, a, c, f, F, alphabet, 1, F_stride, x,
                                lanes, G, W, n_bits, w, m, y, fs, zf, st);
  return static_cast<int>(cudaGetLastError());
}

// k_of_word [B, cap]; csum [B, G * W]; last, ys [B, G, W]; n_words,
// n_symbols, n_splits [B]; outputs found [B, S], q [B, S], k, y [B, S, W]
// for S = n_slots, zeroed (q: -1) by the caller.
extern "C" int rans_plan_splits(
    const void* k_of_word, int cap, const void* csum, const void* last,
    const void* ys, const void* n_words, const void* n_symbols,
    const void* n_splits, int n_contents, int G, int W, int n_slots,
    int window, void* found, void* q, void* k, void* y, void* cuda_stream) {
  plan_splits_kernel<<<n_contents, kPlanBlock, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(k_of_word), cap,
      static_cast<const int32_t*>(csum), static_cast<const int32_t*>(last),
      static_cast<const uint32_t*>(ys), static_cast<const int32_t*>(n_words),
      static_cast<const int32_t*>(n_symbols),
      static_cast<const int32_t*>(n_splits), G, W, n_slots, window,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(q),
      static_cast<int32_t*>(k), static_cast<uint32_t*>(y));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

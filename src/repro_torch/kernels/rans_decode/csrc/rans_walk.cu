// Recoil parallel rANS walk decode (paper §4.1) for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   walk_pointer_kernel <- src/repro/kernels/rans_decode/rans_decode.py
//                          _walk_kernel (with _segment_read_offsets and
//                          _kernel_slot_decode), launched by walk_decode_pallas
//   walk_symbol_kernel  <- src/repro/kernels/rans_decode/rans_decode.py
//                          _walk_kernel_symbol, launched by
//                          walk_decode_symbol_pallas
// and, in both, the scatter that followed them (ops.scatter_outputs): each
// kept symbol is written straight to its place in the flat output, so the
// (rows, steps, 128) tile of the TPU version never exists.
//
// Thread mapping.  One W-thread segment per split, blockDim = 128, so a
// block walks 128 / W splits (W a power of two <= 128).  Thread j of a
// segment is way j: at step t it handles symbol i = (g_hi - t) * W + j.
//
//   reconstruct (i == k_j):  x = (y_j << 16) | word
//   decode      (i <  k_j):  slot = x & (2^n - 1); s, f, F = lut[slot]
//                            x = f * (x >> n) + slot - F
//                            if x < 2^16: x = (x << 16) | word
//
// Pointer layout: the words of one step are consumed in descending lane
// order from the split's stream pointer q, so lane j reads
// stream[q - reads in higher lanes of its split] and then q drops by the
// split's read count.  Within a warp both counts are a __ballot_sync and two
// __popc under the segment mask (the paper's own CUDA design); a split that
// spans 2 or 4 warps (W = 64, 128) adds the counts of its higher warps
// through shared memory, one block barrier per step.  A word is loaded only
// by a lane that reads one, and its index is clipped to the stream as the
// reference clips it.
//
// Symbol layout: lane j reads words_by_symbol[i + sym_base] directly (u16 or
// u32 permutation, one template instance each) -- no pointer, no cross-lane
// step, no barrier.
//
// Slot tables: the packed single-int32 table (n <= 12, <= 16 KB) is staged
// in shared memory; the three-table layout can reach 3 * 2^16 * 4 B =
// 768 KiB at n = 16, beyond the 227 KB a block may have, so it is read
// through the read-only data cache from device memory.
//
// What bounds it on the H100.  The walk does no matrix work and little
// arithmetic per byte; the least time for the work is bytes: each stream
// (or permutation) word read once, the split metadata read once and the
// int32 output written once, over 3.35 TB/s.  A split's steps are a chain of
// dependent loads (table, then word), so this simple design is bound by
// that latency instead: it keeps every split of the request in flight at
// once (one block per 128 / W splits) and lets each block stop at the
// deepest step its own splits need, not the padded step count.  Persistent
// blocks, TMA staging and a narrowed table are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr uint32_t kLowerBound = 1u << 16;

struct SplitArgs {
  const int32_t* k;
  const int32_t* y;
  const int32_t* x0;
  const int32_t* base;  // q0 (pointer layout) or sym_base (symbol layout)
  const int32_t* g_hi;
  const int32_t* start;
  const int32_t* stop;
  const int32_t* keep_lo;
  const int32_t* keep_hi;
  const int32_t* out_base;
};

// slot -> (symbol, f, F).  PACKED: one word sym[0:8] | f[8:20] | F[20:32]
// from shared memory; otherwise three gathers through the read-only cache.
template <bool PACKED>
__device__ __forceinline__ void slot_decode(const int32_t* sym_lut,
                                            const int32_t* __restrict__ f_lut,
                                            const int32_t* __restrict__ F_lut,
                                            uint32_t slot, int32_t& s,
                                            uint32_t& f, uint32_t& F) {
  if constexpr (PACKED) {
    const uint32_t p = static_cast<uint32_t>(sym_lut[slot]);
    s = static_cast<int32_t>(p & 0xFFu);
    f = (p >> 8) & 0xFFFu;
    F = (p >> 20) & 0xFFFu;
  } else {
    s = __ldg(sym_lut + slot);
    f = static_cast<uint32_t>(__ldg(f_lut + slot));
    F = static_cast<uint32_t>(__ldg(F_lut + slot));
  }
}

// Stages the packed table in shared memory (no-op for three tables) and
// returns the table the walk reads.
template <bool PACKED>
__device__ __forceinline__ const int32_t* stage_lut(
    const int32_t* __restrict__ sym_lut, int lut_size, int32_t* smem) {
  if constexpr (PACKED) {
    for (int e = threadIdx.x; e < lut_size; e += kBlock) smem[e] = sym_lut[e];
    return smem;
  } else {
    return sym_lut;
  }
}

// Steps this split needs: from its top group down to the group of `stop`.
__device__ __forceinline__ int split_steps(int g_hi, int start, int stop,
                                           int ways, int n_steps) {
  if (start < 0) return 0;  // inert padding row
  return min(n_steps, g_hi - stop / ways + 1);
}

template <bool PACKED>
__global__ void __launch_bounds__(kBlock)
walk_pointer_kernel(const int32_t* __restrict__ stream, int n_stream,
                    const int32_t* __restrict__ sym_lut,
                    const int32_t* __restrict__ f_lut,
                    const int32_t* __restrict__ F_lut, int lut_size,
                    SplitArgs a, int n_splits, int ways, int n_bits,
                    int n_steps, int32_t* __restrict__ out, int n_out,
                    int32_t* __restrict__ qf) {
  extern __shared__ int32_t smem_lut[];
  __shared__ int warp_reads[2][kBlock / 32];
  __shared__ int block_steps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x * (kBlock / ways) + tid / ways;
  const int j = tid % ways;
  const bool live = split < n_splits;

  const int32_t* lut = stage_lut<PACKED>(sym_lut, lut_size, smem_lut);
  if (tid == 0) block_steps = 0;
  __syncthreads();

  int kk = 0, start = -1, stop = 0, keep_lo = 0, keep_hi = 0, g_hi = 0;
  int out_base = 0, q = 0;
  uint32_t yb = 0, x = 0;
  if (live) {
    const int e = split * ways + j;
    kk = a.k[e];
    yb = static_cast<uint32_t>(a.y[e]) << 16;
    x = static_cast<uint32_t>(a.x0[e]);
    q = a.base[split];
    g_hi = a.g_hi[split];
    start = a.start[split];
    stop = a.stop[split];
    keep_lo = a.keep_lo[split];
    keep_hi = a.keep_hi[split];
    out_base = a.out_base[split];
    if (j == 0)
      atomicMax(&block_steps, split_steps(g_hi, start, stop, ways, n_steps));
  }
  __syncthreads();
  const int steps = block_steps;

  // Lanes of this thread's split within its warp, and those above lane j.
  const int seg_lanes = ways < 32 ? ways : 32;
  const uint32_t seg_mask =
      seg_lanes == 32 ? 0xFFFFFFFFu
                      : ((1u << seg_lanes) - 1u) << (lane / seg_lanes * seg_lanes);
  const uint32_t above = seg_mask & ~(0xFFFFFFFFu >> (31 - lane));
  const int warps_per_split = ways > 32 ? ways / 32 : 1;
  const int first_warp = warp / warps_per_split * warps_per_split;
  const uint32_t slot_mask = (1u << n_bits) - 1u;

  for (int t = 0; t < steps; ++t) {
    const int i = (g_hi - t) * ways + j;
    const bool active = live && i <= start && i >= stop;
    const bool recon = active && i == kk;
    const bool dec = active && i < kk;
    int32_t s = 0;
    uint32_t x_dec = 0;
    if (dec) {
      const uint32_t slot = x & slot_mask;
      uint32_t f, F;
      slot_decode<PACKED>(lut, f_lut, F_lut, slot, s, f, F);
      x_dec = f * (x >> n_bits) + (slot - F);
    }
    const bool under = dec && x_dec < kLowerBound;
    const bool reads = recon || under;
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, reads);
    int higher = __popc(ballot & above);
    int split_reads;
    if (warps_per_split == 1) {
      split_reads = __popc(ballot & seg_mask);
    } else {
      // Double-buffered by step parity: a warp can only overwrite a slot
      // after every warp has passed the next step's barrier, i.e. after
      // every read of this step's counts.
      const int buf = t & 1;
      if (lane == 0) warp_reads[buf][warp] = __popc(ballot);
      __syncthreads();
      split_reads = 0;
      for (int w = first_warp; w < first_warp + warps_per_split; ++w) {
        const int c = warp_reads[buf][w];
        split_reads += c;
        if (w > warp) higher += c;
      }
    }
    if (reads) {
      const int idx = min(max(q - higher, 0), n_stream - 1);
      const uint32_t word = static_cast<uint32_t>(stream[idx]);
      x = recon ? (yb | word) : ((x_dec << 16) | word);
    } else if (dec) {
      x = x_dec;
    }
    q -= split_reads;
    if (dec && i >= keep_lo && i < keep_hi) {
      const int o = i + out_base;
      if (o >= 0 && o < n_out) out[o] = s;
    }
  }
  if (live && j == 0) qf[split] = q;
}

template <bool PACKED, typename PermT>
__global__ void __launch_bounds__(kBlock)
walk_symbol_kernel(const PermT* __restrict__ perm, int n_perm,
                   const int32_t* __restrict__ sym_lut,
                   const int32_t* __restrict__ f_lut,
                   const int32_t* __restrict__ F_lut, int lut_size,
                   SplitArgs a, int n_splits, int ways, int n_bits,
                   int n_steps, int32_t* __restrict__ out, int n_out) {
  extern __shared__ int32_t smem_lut[];
  const int tid = threadIdx.x;
  const int split = blockIdx.x * (kBlock / ways) + tid / ways;
  const int j = tid % ways;

  const int32_t* lut = stage_lut<PACKED>(sym_lut, lut_size, smem_lut);
  __syncthreads();
  if (split >= n_splits) return;

  const int e = split * ways + j;
  const int kk = a.k[e];
  const uint32_t yb = static_cast<uint32_t>(a.y[e]) << 16;
  uint32_t x = static_cast<uint32_t>(a.x0[e]);
  const int g_hi = a.g_hi[split];
  const int start = a.start[split];
  const int stop = a.stop[split];
  const int keep_lo = a.keep_lo[split];
  const int keep_hi = a.keep_hi[split];
  const int out_base = a.out_base[split];
  // Row of the permutation viewed (groups, W) that holds group g_hi.
  const int row0 = g_hi + a.base[split] / ways;
  const int last_row = n_perm / ways - 1;
  const int steps = split_steps(g_hi, start, stop, ways, n_steps);
  const uint32_t slot_mask = (1u << n_bits) - 1u;

  for (int t = 0; t < steps; ++t) {
    const int i = (g_hi - t) * ways + j;
    if (i > start || i < stop || i > kk) continue;
    uint32_t word = 0;
    if (i == kk) {
      word = static_cast<uint32_t>(perm[min(max(row0 - t, 0), last_row) * ways + j]);
      x = yb | word;
      continue;
    }
    const uint32_t slot = x & slot_mask;
    int32_t s;
    uint32_t f, F;
    slot_decode<PACKED>(lut, f_lut, F_lut, slot, s, f, F);
    x = f * (x >> n_bits) + (slot - F);
    if (x < kLowerBound) {
      word = static_cast<uint32_t>(perm[min(max(row0 - t, 0), last_row) * ways + j]);
      x = (x << 16) | word;
    }
    if (i >= keep_lo && i < keep_hi) {
      const int o = i + out_base;
      if (o >= 0 && o < n_out) out[o] = s;
    }
  }
}

int blocks_for(int n_splits, int ways) {
  const int per_block = kBlock / ways;
  return (n_splits + per_block - 1) / per_block;
}

SplitArgs split_args(const void* k, const void* y, const void* x0,
                     const void* base, const void* g_hi, const void* start,
                     const void* stop, const void* keep_lo,
                     const void* keep_hi, const void* out_base) {
  return SplitArgs{static_cast<const int32_t*>(k),
                   static_cast<const int32_t*>(y),
                   static_cast<const int32_t*>(x0),
                   static_cast<const int32_t*>(base),
                   static_cast<const int32_t*>(g_hi),
                   static_cast<const int32_t*>(start),
                   static_cast<const int32_t*>(stop),
                   static_cast<const int32_t*>(keep_lo),
                   static_cast<const int32_t*>(keep_hi),
                   static_cast<const int32_t*>(out_base)};
}

template <typename PermT>
void launch_symbol(const void* perm, int n_perm, const int32_t* sym_lut,
                   const int32_t* f_lut, const int32_t* F_lut, int lut_size,
                   const SplitArgs& a, int n_splits, int ways, int n_bits,
                   int n_steps, int32_t* out, int n_out, cudaStream_t st) {
  const int grid = blocks_for(n_splits, ways);
  const PermT* p = static_cast<const PermT*>(perm);
  if (f_lut == nullptr) {
    walk_symbol_kernel<true, PermT>
        <<<grid, kBlock, lut_size * sizeof(int32_t), st>>>(
            p, n_perm, sym_lut, f_lut, F_lut, lut_size, a, n_splits, ways,
            n_bits, n_steps, out, n_out);
  } else {
    walk_symbol_kernel<false, PermT><<<grid, kBlock, 0, st>>>(
        p, n_perm, sym_lut, f_lut, F_lut, lut_size, a, n_splits, ways,
        n_bits, n_steps, out, n_out);
  }
}

}  // namespace

// Plain C launchers, bound from Python with ctypes.  Every pointer is a
// device pointer; f_lut == nullptr selects the packed table.  Each returns
// cudaGetLastError() after its launch (0 = launched).

extern "C" int rans_walk_pointer(
    const void* stream, int n_stream, const void* sym_lut, const void* f_lut,
    const void* F_lut, int lut_size, const void* k, const void* y,
    const void* x0, const void* q0, const void* g_hi, const void* start,
    const void* stop, const void* keep_lo, const void* keep_hi,
    const void* out_base, int n_splits, int ways, int n_bits, int n_steps,
    void* out, int n_out, void* qf, void* cuda_stream) {
  const SplitArgs a = split_args(k, y, x0, q0, g_hi, start, stop, keep_lo,
                                 keep_hi, out_base);
  const int grid = blocks_for(n_splits, ways);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const int32_t* s = static_cast<const int32_t*>(stream);
  const int32_t* lut = static_cast<const int32_t*>(sym_lut);
  const int32_t* fl = static_cast<const int32_t*>(f_lut);
  const int32_t* Fl = static_cast<const int32_t*>(F_lut);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* q = static_cast<int32_t*>(qf);
  if (fl == nullptr) {
    walk_pointer_kernel<true><<<grid, kBlock, lut_size * sizeof(int32_t), st>>>(
        s, n_stream, lut, fl, Fl, lut_size, a, n_splits, ways, n_bits,
        n_steps, o, n_out, q);
  } else {
    walk_pointer_kernel<false><<<grid, kBlock, 0, st>>>(
        s, n_stream, lut, fl, Fl, lut_size, a, n_splits, ways, n_bits,
        n_steps, o, n_out, q);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rans_walk_symbol(
    const void* perm, int perm_bytes, int n_perm, const void* sym_lut,
    const void* f_lut, const void* F_lut, int lut_size, const void* k,
    const void* y, const void* x0, const void* sym_base, const void* g_hi,
    const void* start, const void* stop, const void* keep_lo,
    const void* keep_hi, const void* out_base, int n_splits, int ways,
    int n_bits, int n_steps, void* out, int n_out, void* cuda_stream) {
  const SplitArgs a = split_args(k, y, x0, sym_base, g_hi, start, stop,
                                 keep_lo, keep_hi, out_base);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const int32_t* lut = static_cast<const int32_t*>(sym_lut);
  const int32_t* fl = static_cast<const int32_t*>(f_lut);
  const int32_t* Fl = static_cast<const int32_t*>(F_lut);
  int32_t* o = static_cast<int32_t*>(out);
  if (perm_bytes == 2) {
    launch_symbol<uint16_t>(perm, n_perm, lut, fl, Fl, lut_size, a, n_splits,
                            ways, n_bits, n_steps, o, n_out, st);
  } else {
    launch_symbol<uint32_t>(perm, n_perm, lut, fl, Fl, lut_size, a, n_splits,
                            ways, n_bits, n_steps, o, n_out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

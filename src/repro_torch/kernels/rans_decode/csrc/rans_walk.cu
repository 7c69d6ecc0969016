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
// Thread mapping.  One W-thread segment per split, blockDim = BLOCK, so a
// block walks BLOCK / W splits (W a power of two <= 128 and BLOCK a power of
// two in [max(W, 32), 1024], both template constants).  Thread j of a
// segment is way j: at step t it handles symbol i = (g_hi - t) * W + j.
//
// Block size.  The Pallas kernels take rows_per_block, the 128-lane vector
// rows of one grid step.  Here it counts warps: BLOCK = 32 * rows_per_block
// threads, each launch picking the instance of its size; the default
// (rows_per_block = None) is the BLOCK = 128 instance, the one every earlier
// version of this file compiled.  Each instance has __launch_bounds__(BLOCK),
// so a larger block never loosens the default's register budget.  Only the
// grid and the shared memory scale with BLOCK; the per-split arithmetic is
// the same in every instance.
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
// through shared memory, one block barrier per step.  The index is clipped
// to the stream as the reference clips it.
//
// Symbol layout: lane j reads words_by_symbol[i + sym_base], row
// (row0 - t) of the permutation viewed (rows, W) -- no pointer, no
// cross-lane count.
//
// Word rings.  Every word a step reads comes from shared memory.  Each split
// owns a ring of 4 chunks of 16-bit words, indexed by the word's global
// position modulo the ring, and refills it from below with 16-byte
// cp.async copies while it decodes from the chunks already resident:
//   * pointer: a split's reads form one descending run, and a step reads
//     only inside [q - W + 1, q], i.e. the chunk of q and the one below
//     (a chunk is max(W, 32) words, so q leaves at most one chunk a step).
//     Those two are waited for; the two below them are in flight.  When q
//     leaves a chunk, its slot is refilled with the chunk four below.  The
//     split's last chunks overshoot its last read by at most one ring
//     (4 * 32 words at W = 32); those words belong to the split below.
//   * symbol: the row a step reads is known before its decode, so the ring
//     holds chunks of 8 rows (one 16-byte copy per lane): the chunk of the
//     current row is waited for, the next two are in flight, and a fourth
//     slot guards the chunk just left.  Loads stop at the split's own last
//     row.
// Refill decisions depend only on q (or the row), which every lane of a
// split holds alike, so no lane diverges from its split; the waits and the
// split's barriers run only on the steps that enter a new chunk.  A word
// past the end of the stream is zero-filled by the copy and never read;
// reads are clipped as the reference clips them.
//
// Slot tables: the packed single-int32 table (n <= 12, <= 16 KB) is staged
// in shared memory with 16-byte cp.async copies; the three-table layout can
// reach 3 * 2^16 * 4 B = 768 KiB at n = 16, beyond the 227 KB a block may
// have, so it is read through the read-only data cache from device memory.
//
// What bounds it on the H100.  The walk does no matrix work and little
// arithmetic per byte; the least time for the work is bytes: each stream
// word (2 B) read once, the split metadata read once and the int32 output
// written once, over 3.35 TB/s.  What holds it back is the chain of
// dependent steps in each split.  The first design paid a device-memory
// load per step (the word's address waited on the step's ballot); with the
// rings a step's critical path is a shared-memory table read, the state
// update, the ballot and a shared-memory word read, every lane runs the
// same branch-free instructions, and the device-memory traffic runs ahead
// of it as 16-bit words.  With few splits the chain's latency is the time;
// with many (one warp each) instruction issue on each SM may add to it (not
// traced).  The grid covers only the splits it is given and each block
// stops at the deepest step its own splits need.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kRingChunks = 4;
constexpr uint32_t kLowerBound = 1u << 16;

// Pointer layout: a chunk must hold a whole step's reads (W words).
template <int W>
struct PointerRing {
  static constexpr int kChunk = W < 32 ? 32 : W;       // words
  static constexpr int kWords = kRingChunks * kChunk;
};

// Symbol layout: 8 permutation rows a chunk, one 16-byte piece a lane.
template <int W>
struct SymbolRing {
  static constexpr int kRows = 8;
  static constexpr int kChunk = kRows * W;              // words
  static constexpr int kWords = kRingChunks * kChunk;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lanes of a warp that belong to lane `lane`'s split (all 32 for
// W >= 32).
template <int W>
__device__ __forceinline__ uint32_t segment_mask(int lane) {
  if constexpr (W >= 32) {
    return 0xFFFFFFFFu;
  } else {
    return ((1u << W) - 1u) << (lane / W * W);
  }
}

// Chunk of position `p` clipped to [0, n): chunks are CHUNK units long.
template <int CHUNK>
__device__ __forceinline__ int chunk_of(int p, int n) {
  return static_cast<unsigned>(min(max(p, 0), n - 1)) / CHUNK;
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Copies chunk `chunk` (CHUNK words of `src`) into its ring slot, one
// 16-byte piece per lane, and commits one cp.async group -- also when the
// chunk lies below `lo_chunk` and nothing is copied, so every lane of a
// split counts the same groups.  Words at or past n_src are zero-filled.
template <int W, int CHUNK, int RING>
__device__ __forceinline__ void fill_chunk(uint16_t* ring,
                                           const uint16_t* __restrict__ src,
                                           int n_src, int chunk, int lo_chunk,
                                           int j) {
  constexpr int kPieces = CHUNK / 8;
  if (chunk >= lo_chunk) {
#pragma unroll
    for (int k = 0; k < (kPieces + W - 1) / W; ++k) {
      const int p = j + k * W;
      if (kPieces % W == 0 || p < kPieces) {
        const int g = chunk * CHUNK + p * 8;
        const int valid = min(max(n_src - g, 0), 8) * 2;
        cp_async16(ring + (g & (RING - 1)), valid > 0 ? src + g : src, valid);
      }
    }
  }
  cp_async_commit();
}

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

// Starts copying the packed table into shared memory (16-byte pieces, one
// cp.async group; the caller's first wait and barrier complete it) and
// returns the table the walk reads.  No-op for three tables.
template <bool PACKED, int BLOCK>
__device__ __forceinline__ const int32_t* stage_lut(
    const int32_t* __restrict__ sym_lut, int lut_size, int32_t* smem) {
  if constexpr (PACKED) {
    const int pieces = lut_size / 4;
    for (int e = threadIdx.x; e < pieces; e += BLOCK)
      cp_async16(smem + 4 * e, sym_lut + 4 * e, 16);
    for (int e = pieces * 4 + threadIdx.x; e < lut_size; e += BLOCK)
      smem[e] = sym_lut[e];
    cp_async_commit();
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

template <bool PACKED, int W, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
walk_pointer_kernel(const uint16_t* __restrict__ stream, int n_stream,
                    const int32_t* __restrict__ sym_lut,
                    const int32_t* __restrict__ f_lut,
                    const int32_t* __restrict__ F_lut, int lut_size,
                    SplitArgs a, int n_rows, int n_bits, int n_steps,
                    int32_t* __restrict__ out, int n_out,
                    int32_t* __restrict__ qf) {
  using Ring = PointerRing<W>;
  constexpr int kWarpsPerSplit = W > 32 ? W / 32 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_reads[2][BLOCK / 32];
  __shared__ int block_steps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x * (BLOCK / W) + tid / W;
  const int j = tid % W;
  const bool live = split < n_rows;

  const int32_t* lut =
      stage_lut<PACKED, BLOCK>(sym_lut, lut_size,
                               reinterpret_cast<int32_t*>(smem));
  uint16_t* ring = reinterpret_cast<uint16_t*>(
                       smem + align16(PACKED ? lut_size * 4 : 0)) +
                   (tid / W) * Ring::kWords;
  if (tid == 0) block_steps = 0;
  __syncthreads();

  int kk = 0, start = -1, stop = 0, keep_lo = 0, keep_hi = 0, g_hi = 0;
  int out_base = 0, q = 0;
  uint32_t yb = 0, x = 0;
  if (live) {
    const int e = split * W + j;
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
      atomicMax(&block_steps, split_steps(g_hi, start, stop, W, n_steps));
  }

  // Ring: chunks top .. top - 3 of the stream; a split that never reads
  // copies nothing but commits the same groups.
  const int lo_chunk = live && start >= 0 ? 0 : INT_MAX;
  int top = chunk_of<Ring::kChunk>(q, n_stream);
  for (int c = 0; c < kRingChunks; ++c)
    fill_chunk<W, Ring::kChunk, Ring::kWords>(ring, stream, n_stream, top - c,
                                              lo_chunk, j);
  cp_async_wait<kRingChunks - 2>();
  __syncthreads();
  const int steps = block_steps;

  // Lanes of this thread's split within its warp, and those above lane j.
  const uint32_t seg_mask = segment_mask<W>(lane);
  const uint32_t above = seg_mask & ~(0xFFFFFFFFu >> (31 - lane));
  const int first_warp = warp / kWarpsPerSplit * kWarpsPerSplit;
  const uint32_t slot_mask = (1u << n_bits) - 1u;

  // Branch-free steps: every lane decodes and reads a word (both from
  // shared memory, at indices that are always in range) and keeps what its
  // state says it needs.  Kept rolled: unrolled by two, the step measured
  // slower on the H100 at every split count.
  int i = g_hi * W + j;
#pragma unroll 1
  for (int t = 0; t < steps; ++t, i -= W) {
    const bool active = live && i <= start && i >= stop;
    const bool recon = active && i == kk;
    const bool dec = active && i < kk;
    const uint32_t slot = x & slot_mask;
    int32_t s;
    uint32_t f, F;
    slot_decode<PACKED>(lut, f_lut, F_lut, slot, s, f, F);
    const uint32_t x_dec = f * (x >> n_bits) + (slot - F);
    const bool reads = recon || (dec && x_dec < kLowerBound);
    if constexpr (kWarpsPerSplit > 1) cp_async_wait<kRingChunks - 2>();
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, reads);
    int higher = __popc(ballot & above);
    int split_reads;
    if constexpr (kWarpsPerSplit == 1) {
      split_reads = __popc(ballot & seg_mask);
    } else {
      // Double-buffered by step parity: a warp can only overwrite a slot
      // after every warp has passed the next step's barrier, i.e. after
      // every read of this step's counts.  The barrier also publishes the
      // ring chunks waited for above.
      const int buf = t & 1;
      if (lane == 0) warp_reads[buf][warp] = __popc(ballot);
      __syncthreads();
      split_reads = 0;
      for (int w = first_warp; w < first_warp + kWarpsPerSplit; ++w) {
        const int cnt = warp_reads[buf][w];
        split_reads += cnt;
        if (w > warp) higher += cnt;
      }
    }
    const int idx = min(max(q - higher, 0), n_stream - 1);
    const uint32_t word = ring[idx & (Ring::kWords - 1)];
    const uint32_t x_read = (recon ? yb : x_dec << 16) | word;
    x = reads ? x_read : (dec ? x_dec : x);
    q -= split_reads;
    const int o = i + out_base;
    if (dec && i >= keep_lo && i < keep_hi && o >= 0 && o < n_out) out[o] = s;
    // When q leaves its chunk, the chunk's slot takes the chunk four below,
    // once every lane of the split is done with this step's words; then the
    // chunk now below q's must have landed, for every lane.
    const int c = chunk_of<Ring::kChunk>(q, n_stream);
    if constexpr (kWarpsPerSplit == 1) {
      if (c < top) {  // uniform over the split
        __syncwarp(seg_mask);
        top = c;
        fill_chunk<W, Ring::kChunk, Ring::kWords>(
            ring, stream, n_stream, top - (kRingChunks - 1), lo_chunk, j);
        cp_async_wait<kRingChunks - 2>();
        __syncwarp(seg_mask);
      }
    } else {
      __syncthreads();
      if (c < top) {
        top = c;
        fill_chunk<W, Ring::kChunk, Ring::kWords>(
            ring, stream, n_stream, top - (kRingChunks - 1), lo_chunk, j);
      }
    }
  }
  cp_async_wait<0>();
  if (live && j == 0) qf[split] = q;
}

template <bool PACKED, int W, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
walk_symbol_kernel(const uint16_t* __restrict__ perm, int n_perm,
                   const int32_t* __restrict__ sym_lut,
                   const int32_t* __restrict__ f_lut,
                   const int32_t* __restrict__ F_lut, int lut_size,
                   SplitArgs a, int n_rows, int n_bits, int n_steps,
                   int32_t* __restrict__ out, int n_out) {
  using Ring = SymbolRing<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int block_steps;

  const int tid = threadIdx.x;
  const int split = blockIdx.x * (BLOCK / W) + tid / W;
  const int j = tid % W;
  const bool live = split < n_rows;

  const int32_t* lut =
      stage_lut<PACKED, BLOCK>(sym_lut, lut_size,
                               reinterpret_cast<int32_t*>(smem));
  uint16_t* ring = reinterpret_cast<uint16_t*>(
                       smem + align16(PACKED ? lut_size * 4 : 0)) +
                   (tid / W) * Ring::kWords;
  if (tid == 0) block_steps = 0;
  __syncthreads();

  int kk = 0, start = -1, stop = 0, keep_lo = 0, keep_hi = 0, g_hi = 0;
  int out_base = 0, row0 = 0, my_steps = 0;
  uint32_t yb = 0, x = 0;
  const int last_row = n_perm / W - 1;
  if (live) {
    const int e = split * W + j;
    kk = a.k[e];
    yb = static_cast<uint32_t>(a.y[e]) << 16;
    x = static_cast<uint32_t>(a.x0[e]);
    g_hi = a.g_hi[split];
    start = a.start[split];
    stop = a.stop[split];
    keep_lo = a.keep_lo[split];
    keep_hi = a.keep_hi[split];
    out_base = a.out_base[split];
    // Row of the permutation viewed (rows, W) that holds group g_hi.
    row0 = g_hi + a.base[split] / W;
    my_steps = split_steps(g_hi, start, stop, W, n_steps);
    if (j == 0) atomicMax(&block_steps, my_steps);
  }

  // Ring: chunks of 8 rows, from the chunk of row0 down to the chunk of the
  // split's last row; the slot of the chunk just left guards its readers.
  const int lo_chunk =
      my_steps > 0 ? chunk_of<Ring::kRows>(row0 - my_steps + 1, last_row + 1)
                   : INT_MAX;
  int top = chunk_of<Ring::kRows>(row0, last_row + 1);
  for (int c = 0; c < kRingChunks - 1; ++c)
    fill_chunk<W, Ring::kChunk, Ring::kWords>(ring, perm, n_perm, top - c,
                                              lo_chunk, j);
  cp_async_wait<kRingChunks - 2>();   // the table and the first chunk
  __syncthreads();
  const int steps = block_steps;
  const uint32_t seg_mask = segment_mask<W>(tid & 31);
  const uint32_t slot_mask = (1u << n_bits) - 1u;

  int i = g_hi * W + j;
  for (int t = 0; t < steps; ++t, i -= W) {
    const int r = min(max(row0 - t, 0), last_row);
    const int c = static_cast<unsigned>(r) / Ring::kRows;
    // Entering a chunk: its copies (issued two chunks ago) must have
    // landed, for every lane; meanwhile the chunk two below starts.
    if constexpr (W <= 32) {
      if (c < top) {  // uniform over the split
        top = c;
        fill_chunk<W, Ring::kChunk, Ring::kWords>(
            ring, perm, n_perm, top - (kRingChunks - 2), lo_chunk, j);
        cp_async_wait<kRingChunks - 2>();
        __syncwarp(seg_mask);
      }
    } else {
      if (c < top) {
        top = c;
        fill_chunk<W, Ring::kChunk, Ring::kWords>(
            ring, perm, n_perm, top - (kRingChunks - 2), lo_chunk, j);
      }
      cp_async_wait<kRingChunks - 2>();
      __syncthreads();
    }
    const bool active = live && i <= start && i >= stop;
    const bool recon = active && i == kk;
    const bool dec = active && i < kk;
    const uint32_t word = ring[(r * W + j) & (Ring::kWords - 1)];
    const uint32_t slot = x & slot_mask;
    int32_t s;
    uint32_t f, F;
    slot_decode<PACKED>(lut, f_lut, F_lut, slot, s, f, F);
    const uint32_t x_dec = f * (x >> n_bits) + (slot - F);
    const uint32_t x_next = x_dec < kLowerBound ? (x_dec << 16) | word : x_dec;
    x = recon ? (yb | word) : (dec ? x_next : x);
    const int o = i + out_base;
    if (dec && i >= keep_lo && i < keep_hi && o >= 0 && o < n_out) out[o] = s;
  }
  cp_async_wait<0>();
}

int blocks_for(int n_rows, int ways, int block) {
  const int per_block = block / ways;
  return (n_rows + per_block - 1) / per_block;
}

// A block above 48 KB of dynamic shared memory must opt in (per device, so
// on every launch that needs it; the default blocks stay below): sized for
// the largest table the instance can stage.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Largest slot table staged in shared memory: the packed table, n <= 12.
constexpr int kMaxLutBytes = 4 << 12;

int lut_bytes(bool packed, int lut_size) {
  return align16(packed ? lut_size * 4 : 0);
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

struct Launch {
  const uint16_t* words;
  int n_words;
  const int32_t* sym_lut;
  const int32_t* f_lut;
  const int32_t* F_lut;
  int lut_size;
  SplitArgs a;
  int n_rows;
  int n_bits;
  int n_steps;
  int32_t* out;
  int n_out;
  int32_t* qf;
  cudaStream_t st;
};

// Each launcher returns the error of its launch (0 = launched).
template <bool PACKED, int W, int BLOCK>
struct PointerLaunch {
  static int run(const Launch& L) {
    constexpr size_t kRing =
        (BLOCK / W) * PointerRing<W>::kWords * sizeof(uint16_t);
    const cudaError_t attr = allow_smem(walk_pointer_kernel<PACKED, W, BLOCK>,
                                        (PACKED ? kMaxLutBytes : 0) + kRing);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    walk_pointer_kernel<PACKED, W, BLOCK>
        <<<blocks_for(L.n_rows, W, BLOCK), BLOCK,
           lut_bytes(PACKED, L.lut_size) + kRing, L.st>>>(
            L.words, L.n_words, L.sym_lut, L.f_lut, L.F_lut, L.lut_size, L.a,
            L.n_rows, L.n_bits, L.n_steps, L.out, L.n_out, L.qf);
    return static_cast<int>(cudaGetLastError());
  }
};

template <bool PACKED, int W, int BLOCK>
struct SymbolLaunch {
  static int run(const Launch& L) {
    constexpr size_t kRing =
        (BLOCK / W) * SymbolRing<W>::kWords * sizeof(uint16_t);
    const cudaError_t attr = allow_smem(walk_symbol_kernel<PACKED, W, BLOCK>,
                                        (PACKED ? kMaxLutBytes : 0) + kRing);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    walk_symbol_kernel<PACKED, W, BLOCK>
        <<<blocks_for(L.n_rows, W, BLOCK), BLOCK,
           lut_bytes(PACKED, L.lut_size) + kRing, L.st>>>(
            L.words, L.n_words, L.sym_lut, L.f_lut, L.F_lut, L.lut_size, L.a,
            L.n_rows, L.n_bits, L.n_steps, L.out, L.n_out);
    return static_cast<int>(cudaGetLastError());
  }
};

// One instance per (table layout, W, block): W 8..128 and blocks of
// max(W, 32) to 1024 threads, powers of two; anything else is refused.
template <template <bool, int, int> class Launcher, bool PACKED, int W>
int launch_block(int block, const Launch& L) {
  switch (block) {
    case 32:
      if constexpr (W <= 32) return Launcher<PACKED, W, 32>::run(L);
      break;
    case 64:
      if constexpr (W <= 64) return Launcher<PACKED, W, 64>::run(L);
      break;
    case 128: return Launcher<PACKED, W, 128>::run(L);
    case 256: return Launcher<PACKED, W, 256>::run(L);
    case 512: return Launcher<PACKED, W, 512>::run(L);
    case 1024: return Launcher<PACKED, W, 1024>::run(L);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <template <bool, int, int> class Launcher, bool PACKED>
int launch_ways(int ways, int block, const Launch& L) {
  switch (ways) {
    case 8: return launch_block<Launcher, PACKED, 8>(block, L);
    case 16: return launch_block<Launcher, PACKED, 16>(block, L);
    case 32: return launch_block<Launcher, PACKED, 32>(block, L);
    case 64: return launch_block<Launcher, PACKED, 64>(block, L);
    case 128: return launch_block<Launcher, PACKED, 128>(block, L);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C launchers, bound from Python with ctypes.  Every pointer is a
// device pointer; the stream and the permutation are 16-bit words and must
// be 16-byte aligned, as must the slot tables; f_lut == nullptr selects the
// packed table.  The grid covers all n_rows splits in blocks of `block`
// threads (128 unless the caller chose).  Each returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a (ways, block) pair with no instance.

extern "C" int rans_walk_pointer(
    const void* stream, int n_stream, const void* sym_lut, const void* f_lut,
    const void* F_lut, int lut_size, const void* k, const void* y,
    const void* x0, const void* q0, const void* g_hi, const void* start,
    const void* stop, const void* keep_lo, const void* keep_hi,
    const void* out_base, int n_rows, int ways, int n_bits, int n_steps,
    void* out, int n_out, void* qf, int block, void* cuda_stream) {
  const Launch L{static_cast<const uint16_t*>(stream),
                 n_stream,
                 static_cast<const int32_t*>(sym_lut),
                 static_cast<const int32_t*>(f_lut),
                 static_cast<const int32_t*>(F_lut),
                 lut_size,
                 split_args(k, y, x0, q0, g_hi, start, stop, keep_lo, keep_hi,
                            out_base),
                 n_rows,
                 n_bits,
                 n_steps,
                 static_cast<int32_t*>(out),
                 n_out,
                 static_cast<int32_t*>(qf),
                 static_cast<cudaStream_t>(cuda_stream)};
  return f_lut == nullptr
             ? launch_ways<PointerLaunch, true>(ways, block, L)
             : launch_ways<PointerLaunch, false>(ways, block, L);
}

extern "C" int rans_walk_symbol(
    const void* perm, int n_perm, const void* sym_lut, const void* f_lut,
    const void* F_lut, int lut_size, const void* k, const void* y,
    const void* x0, const void* sym_base, const void* g_hi, const void* start,
    const void* stop, const void* keep_lo, const void* keep_hi,
    const void* out_base, int n_rows, int ways, int n_bits, int n_steps,
    void* out, int n_out, int block, void* cuda_stream) {
  const Launch L{static_cast<const uint16_t*>(perm),
                 n_perm,
                 static_cast<const int32_t*>(sym_lut),
                 static_cast<const int32_t*>(f_lut),
                 static_cast<const int32_t*>(F_lut),
                 lut_size,
                 split_args(k, y, x0, sym_base, g_hi, start, stop, keep_lo,
                            keep_hi, out_base),
                 n_rows,
                 n_bits,
                 n_steps,
                 static_cast<int32_t*>(out),
                 n_out,
                 nullptr,
                 static_cast<cudaStream_t>(cuda_stream)};
  return f_lut == nullptr
             ? launch_ways<SymbolLaunch, true>(ways, block, L)
             : launch_ways<SymbolLaunch, false>(ways, block, L);
}

extern "C" const char* rans_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Leaf-channel batched histograms for the wave grower, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py:
//   * build_histogram_pallas_leaves (:852): _hist_leaves_kernel (:558,
//     pallas_call :641) and the DMA form _leaves_dma_common (:670) with
//     _make_w128_bf16 (:770) (pallas_call :809): 25 leaf channels of
//     (sum g*mask, sum h*mask, count)  ->  hist_leaves_fx;
//   * build_histogram_pallas_leaves_q8 (:1030): _hist_leaves_q8_kernel
//     (:927, pallas_call :984) and the DMA form with _make_w128_q8 (:781):
//     42 leaf channels of int32 (sum g_q, sum h_q, count) from int8
//     weights  ->  hist_leaves_q8;
//   * the nibble-packed forms of both (_leaves_dma_common with packed=True,
//     behind bins_packed=True): bins arrive as (F, N/2) bytes, row 2j in the
//     low nibble of byte j and row 2j+1 in the high nibble
//     (ops/histogram.py pack_bins4), B <= 16  ->  hist_leaves_{fx,q8}_p4.
// The TPU kernels turn the scatter-add into a one-hot MXU contraction
// because the TPU has no fast atomics.  Hopper has shared-memory atomics,
// so this is the scatter-add itself.  (The one-hot product would cost
// ~19 T int8 operations per q8 launch at the main shape: wgmma does not
// pay here.)
//
// Both weight types accumulate INTEGERS, so the result does not depend on
// the order in which atomics land and is bit-identical from run to run and
// to the plain versions (ops/histogram_cuda.py *_plain):
//   * q8: int8 weights -> int32 sums (as the reference, exact);
//   * fx: the wrapper converts g*mask and h*mask to 64-bit fixed point with
//     a per-tree power-of-two scale (ops/histogram.py pack_weights), the
//     kernel sums int64, the wrapper scales back to f32.  The count row is
//     pack_weights' 0/1 membership, summed in 32 bits per block.
//
// The bound on the H100: bytes.  chip_smoke.py counts each input byte once:
// the channel byte of every row, the F bin bytes and the weights (24 B fx,
// 3 B q8) of every row in a channel, and the (K, F, B, 3) output; at the
// main shape (F=28, N=10,502,144, B=256, half the rows in a channel) about
// 0.17-0.18 GB, 0.05 ms at 3.35 TB/s.  The work itself is 3 (fx) or 2 (q8)
// shared-memory atomics per (row in a channel, feature): 441M or 294M.
//
// Design, and which cause of the first version's time each part answers
// (PERF.md section 6):
//  1. Fill the SM.  A block owns a GROUP of cg channels x fg features and
//     keeps only their histograms in shared memory: per (channel, feature)
//     B x 20 bytes for fx (int64 g and h, int32 count) and B x 12 for q8
//     (one int64 packing (g, h), int32 count).  ops/histogram_cuda.py
//     leaf_geometry sizes the groups for one resident block of 1024
//     threads: 32 warps on every SM (the first version held 16 at
//     B=256).  It takes the fewest block columns, then the most channels
//     per block: the fastest group of every form in a replayed wave
//     iteration (PERF.md section 6).  A row outside the block's channels
//     costs one byte.
//  2. Flush a few times, not 41.  The grid is (channel x feature groups,
//     row chunks), sized from the SM count so that the whole grid is ONE
//     resident round; each block walks one long row chunk and flushes its
//     histogram once with global atomics.
//  3. Rows in flight, and full warps at the atomics.  Each warp reads the
//     channel bytes of 128 rows per step with one 4-byte load per lane
//     (four steps' loads issued together), and compacts
//     the rows that fall in the block's channels into a per-warp queue in
//     shared memory (a warp prefix sum of the lanes' counts, so the queue
//     keeps row order and a round's rows share sectors).  Whenever the
//     queue holds 32 rows, every lane takes one: its weights (q8: three
//     bytes, fx: three int64), then per feature of the group its bin
//     (loads of four features issued together) and the adds.  So every
//     atomic instruction carries 32 rows, however few rows a channel
//     group holds (the first version's lanes idled on rows of other
//     leaves; a late wave or a small channel group leaves most of them
//     idle), and a step whose rows are all elsewhere costs one load.
//  4. A row's channel and weights are read once per FEATURE GROUP, not once
//     per feature: fg features share them.
//  q8 adds (g, h) as one 64-bit atomic of (g << 32) + h: with at most 2^24
//  rows per block (leaf_geometry caps the chunk), |sum h| <= 128 * 2^24 =
//  2^31, so the low word holds sum h as a signed 32-bit value and the high
//  word sum g, with no carry lost (tests/test_torch_hist_geometry.py).
//
// Times (CUDA events; chip_smoke.py phase 2 at F=28, N=10,502,144, half
// the rows in a channel; NVIDIA H100 80GB HBM3, 700 W), with the first
// version's (the same call) and one index_add_ of the same sums beside
// them:
//   hist_leaves_fx     B=256  1.110 ms  (first version 6.326, f32 3.263)
//   hist_leaves_q8     B=256  1.119 ms  (5.358, int32 4.745)
//   hist_leaves_fx_p4  B=16   1.078 ms  (2.444, int64 9.381)
//   hist_leaves_q8_p4  B=16   0.658 ms  (1.098, int32 6.965)
// 15-21x the byte bound; PERF.md section 6 has the sweeps behind the
// geometry and what each part of the design bought.
//
// uint16 bin codes (max_bin > 255; the reference's wave grower then
// histograms with XLA, lightgbm_tpu/learner/wave.py:287-294, no Pallas
// form): the same kernel templated on the bin type (hist_leaves_fx_u16,
// hist_leaves_q8_u16).  A (channel, feature) pair takes B x 20 (fx) or
// B x 12 (q8) bytes, so past 10,598 (fx) or 17,664 (q8) bins no group
// fits a block: the grid's block columns then also run over BIN TILES,
// a block keeping bins [b0, b0 + Bt) of its group and dropping every
// other add (leaf_geometry picks Bt; the uint8 forms run one tile of B).
// Each extra tile re-reads the rows' channels, and the queued rows'
// weights and bins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // 64 registers a thread: one block per SM
constexpr int kLaneRows = 4;       // rows of one lane per warp step
constexpr int kWarpRows = 32 * kLaneRows;
constexpr int kQueue = kWarpRows + 32;   // queue entries per warp
constexpr int kAhead = 4;          // warp steps whose channels load at once
constexpr int kChBits = 7;         // queue entry: row << 7 | channel

__device__ __forceinline__ unsigned int load_ch4(const int8_t* ch,
                                                 long long r, long long r1,
                                                 bool vec) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(ch) + r;
  if (vec && r + kLaneRows <= r1)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  unsigned int v = 0u;
#pragma unroll
  for (int j = 0; j < kLaneRows; ++j)
    v |= (r + j < r1 ? (unsigned int)p[j] : 0xffu) << (8 * j);
  return v;
}

template <typename BT, bool PACKED>
__device__ __forceinline__ int bin_of(const BT* __restrict__ col,
                                      long long row) {
  if constexpr (PACKED) {
    return (__ldg(col + (row >> 1)) >> ((row & 1) * 4)) & 15;
  } else {
    return __ldg(col + row);
  }
}

// One queued row: its weights once, then its bin and adds for every
// feature of the block's group (four features' loads at a time).
// Bins [b0, b0 + nbt) of the block's tile are its histogram's; others
// are dropped.
template <typename W, typename BT, bool PACKED>
__device__ __forceinline__ void add_row(
    unsigned long long* acc, unsigned int* cnt_acc, int E,
    const BT* __restrict__ bins, const W* __restrict__ w,
    long long fstride, long long N, int b0, int nbt, int nf, long long row,
    int ci) {
  constexpr bool Q8 = sizeof(W) == 1;
  long long g, h;
  unsigned int n;
  if constexpr (Q8) {
    g = __ldg(w + row);
    h = __ldg(w + N + row);
    n = (unsigned int)(int)__ldg(w + 2 * N + row);
  } else {
    g = __ldg(w + row);
    h = __ldg(w + N + row);
    n = (unsigned int)__ldg(w + 2 * N + row);
  }
  if ((g | h) == 0 && n == 0u) return;
  unsigned long long gh = 0ULL;   // q8: (g << 32) + h
  if constexpr (Q8) gh = (unsigned long long)((g << 32) + h);
  const int base = ci * nf * nbt;
  for (int k = 0; k < nf; k += 4) {
    unsigned int b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = k + i < nf ? (unsigned int)(bin_of<BT, PACKED>(
                              bins + (k + i) * fstride, row) - b0)
                        : (unsigned int)nbt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // outside the histogram (or this tile), as in plain
      if (b[i] >= (unsigned int)nbt) continue;
      const int e = base + (k + i) * nbt + (int)b[i];
      if constexpr (Q8) {
        if (gh) atomicAdd(acc + e, gh);
      } else {
        if (g) atomicAdd(acc + e, (unsigned long long)g);
        if (h) atomicAdd(acc + E + e, (unsigned long long)h);
      }
      if (n) atomicAdd(cnt_acc + e, n);
    }
  }
}

// bins: (F, N) uint8 or uint16 (BT) feature-major, or (F, N/2)
// nibble-packed bytes when PACKED.  w: (wrows, N) weights, rows 0..2 are
// (g, h, count).  ch: (N,) int8 leaf channel.  out: (K, F, B, 3), int32
// (q8) or int64 (fx).  Block (x, y): channels [c0, c0 + cg), features
// [f0, f0 + fg) and bins [b0, b0 + Bt) of combination x (channel groups
// fastest, then feature groups, then bin tiles), rows [y * chunk_rows,
// ...).
template <typename W, typename BT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
hist_leaves_kernel(const BT* __restrict__ bins, const W* __restrict__ w,
                   const int8_t* __restrict__ ch, void* __restrict__ out,
                   int F, long long N, int B, int K, int cg, int fg, int Bt,
                   long long chunk_rows, int vec,
                   const long long* __restrict__ lanes, int L) {
  constexpr bool Q8 = sizeof(W) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {   // the model-axis form: lane blockIdx.z's inputs
    const int z = blockIdx.z;
    w = reinterpret_cast<const W*>(lanes[z]);
    ch = reinterpret_cast<const int8_t*>(lanes[L + z]);
    out = static_cast<unsigned char*>(out) +
          (long long)z * K * F * B * 3 * (Q8 ? 4 : 8);
  }

  const int c_groups = (K + cg - 1) / cg;
  const int f_groups = (F + fg - 1) / fg;
  const int c0 = (blockIdx.x % c_groups) * cg;
  const int fx = blockIdx.x / c_groups;
  const int f0 = (fx % f_groups) * fg;
  const int b0 = (fx / f_groups) * Bt;
  const int nc = min(cg, K - c0);
  const int nf = min(fg, F - f0);
  const int nbt = min(Bt, B - b0);
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min(N, r0 + chunk_rows);
  const int E = nc * nf * nbt;
  const int E_alloc = cg * fg * Bt;
  // fx: int64 g[E], int64 h[E]; q8: int64 (g << 32) + h [E]; then
  // uint32 count[E]; then the warps' queues.  Entry (ci, k, b) =
  // (ci * nf + k) * nbt + b - b0.
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* cnt_acc =
      reinterpret_cast<unsigned int*>(acc + (Q8 ? E_alloc : 2 * E_alloc));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned int* queue = cnt_acc + E_alloc + warp * kQueue;
  for (int i = threadIdx.x; i < (Q8 ? E : 2 * E); i += blockDim.x)
    acc[i] = 0ULL;
  for (int i = threadIdx.x; i < E; i += blockDim.x) cnt_acc[i] = 0u;
  __syncthreads();

  const bool vv = vec != 0;
  const long long fstride = PACKED ? N / 2 : N;   // bin bytes per feature
  const BT* col0 = bins + (long long)f0 * fstride;
  const long long step = (long long)nwarps * kWarpRows;   // rows a block
  int qn = 0;   // rows queued by this warp (the same in every lane)
  for (long long t = r0 + (long long)warp * kWarpRows; t < r1;
       t += kAhead * step) {
    unsigned int cv[kAhead];   // kAhead steps' channels, loaded together
#pragma unroll
    for (int p = 0; p < kAhead; ++p)
      cv[p] = load_ch4(ch, t + p * step + lane * kLaneRows, r1, vv);
#pragma unroll
    for (int p = 0; p < kAhead; ++p) {
      const long long tp = t + p * step;
      if (tp >= r1) break;
      // queue the rows of this block's channels, in row order: a warp
      // prefix sum of the lanes' counts places each lane's rows
      unsigned int act = 0u;
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        const int c = (int)(signed char)(cv[p] >> (8 * j)) - c0;
        if ((unsigned int)c < (unsigned int)nc) act |= 1u << j;
      }
      const int mine = __popc(act);
      int inc = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int total = __shfl_sync(0xffffffffu, inc, 31);
      int pos = qn + inc - mine;
      const long long rl = tp + lane * kLaneRows - r0;
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        if ((act >> j) & 1u) {
          const int c = (int)(signed char)(cv[p] >> (8 * j)) - c0;
          queue[pos++] = ((unsigned int)(rl + j) << kChBits) | (unsigned int)c;
        }
      }
      qn += total;
      __syncwarp();
      while (qn >= 32) {   // full rounds, taken from the end of the queue
        qn -= 32;
        const unsigned int e = queue[qn + lane];
        add_row<W, BT, PACKED>(acc, cnt_acc, E, col0, w, fstride, N, b0,
                               nbt, nf, r0 + (e >> kChBits),
                               (int)(e & ((1u << kChBits) - 1)));
      }
      __syncwarp();
    }
  }
  if (lane < qn) {
    const unsigned int e = queue[lane];
    add_row<W, BT, PACKED>(acc, cnt_acc, E, col0, w, fstride, N, b0, nbt,
                           nf, r0 + (e >> kChBits),
                           (int)(e & ((1u << kChBits) - 1)));
  }
  __syncthreads();

  // flush: entry (ci, k, b) -> out[((c0 + ci) * F + f0 + k) * B + b0 + b]
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int b = i % nbt;
    const int q = i / nbt;
    const long long o =
        (((long long)(c0 + q / nf) * F + (f0 + q % nf)) * B + b0 + b) * 3;
    const unsigned int n = cnt_acc[i];
    if constexpr (Q8) {
      const unsigned long long a = acc[i];
      const int hs = (int)(unsigned int)(a & 0xffffffffULL);
      const int gs = (int)((long long)(a - (unsigned long long)(long long)hs)
                           >> 32);
      int* o32 = static_cast<int*>(out) + o;
      if (gs) atomicAdd(o32, gs);
      if (hs) atomicAdd(o32 + 1, hs);
      if (n) atomicAdd(o32 + 2, (int)n);
    } else {
      unsigned long long* o64 = static_cast<unsigned long long*>(out) + o;
      if (acc[i]) atomicAdd(o64, acc[i]);
      if (acc[E + i]) atomicAdd(o64 + 1, acc[E + i]);
      if (n) atomicAdd(o64 + 2, (unsigned long long)n);
    }
  }
}

// lanes: null for one lane, else the device table (2, L) of each lane's
// weight and channel pointers, with out the lanes' (L, K, F, B, 3).
// Bt: bins per tile (B: one tile, the uint8 forms).
template <typename W, bool PACKED, typename BT = uint8_t>
int launch(const void* bins, const void* w, const void* ch, void* out, int F,
           long long N, int B, int K, int cg, int fg, int chunks,
           long long chunk_rows, int vec, void* stream,
           const long long* lanes = nullptr, int L = 1, int Bt = 0) {
  if (F <= 0 || N <= 0 || K <= 0 || L <= 0) return 0;
  if (Bt == 0) Bt = B;
  if (L > 65535 || Bt < 0 || Bt > B) return (int)cudaErrorInvalidValue;
  if (cg >= (1 << kChBits) || chunk_rows > (1LL << (32 - kChBits)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cg * fg * Bt * (sizeof(W) == 1 ? 12 : 20) +
                      (size_t)(kThreads / 32) * kQueue * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hist_leaves_kernel<W, BT, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int combos = ((K + cg - 1) / cg) * ((F + fg - 1) / fg) *
                     ((B + Bt - 1) / Bt);
  dim3 grid(combos, chunks, L);
  hist_leaves_kernel<W, BT, PACKED>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const BT*>(bins), static_cast<const W*>(w),
          static_cast<const int8_t*>(ch), out, F, N, B, K, cg, fg, Bt,
          chunk_rows, vec, lanes, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All four forms take: bins, weights, ch, out (zero-filled by the caller),
// F, N (rows), B, K, cg, fg (channels and features per block), chunks (row
// chunks), chunk_rows (a multiple of 16, at most 2^25), vec (1: ch is
// 4-byte aligned), stream.  Blocks of 1024 threads.

// 42-channel quantized histogram: wch (8, N) int8 [g_q, h_q, count, 0...],
// out (K, F, B, 3) int32; chunk_rows <= 2^24.
int hist_leaves_q8(const void* bins, const void* wch, const void* ch,
                   void* out, int F, long long N, int B, int K, int cg,
                   int fg, int chunks, long long chunk_rows, int vec,
                   void* stream) {
  return launch<int8_t, false>(bins, wch, ch, out, F, N, B, K, cg, fg,
                               chunks, chunk_rows, vec, stream);
}

// 25-channel exact histogram on 64-bit fixed-point weights: w (3, N) int64
// (count row 0/1), out (K, F, B, 3) int64.
int hist_leaves_fx(const void* bins, const void* w, const void* ch,
                   void* out, int F, long long N, int B, int K, int cg,
                   int fg, int chunks, long long chunk_rows, int vec,
                   void* stream) {
  return launch<long long, false>(bins, w, ch, out, F, N, B, K, cg, fg,
                                  chunks, chunk_rows, vec, stream);
}

// The uint16 forms (max_bin > 255): bins (F, N) uint16 codes; Bt bins
// per tile (block columns: channel groups x feature groups x
// ceil(B / Bt) tiles).
int hist_leaves_q8_u16(const void* bins, const void* wch, const void* ch,
                       void* out, int F, long long N, int B, int K, int cg,
                       int fg, int Bt, int chunks, long long chunk_rows,
                       int vec, void* stream) {
  return launch<int8_t, false, uint16_t>(bins, wch, ch, out, F, N, B, K, cg,
                                         fg, chunks, chunk_rows, vec, stream,
                                         nullptr, 1, Bt);
}

int hist_leaves_fx_u16(const void* bins, const void* w, const void* ch,
                       void* out, int F, long long N, int B, int K, int cg,
                       int fg, int Bt, int chunks, long long chunk_rows,
                       int vec, void* stream) {
  return launch<long long, false, uint16_t>(bins, w, ch, out, F, N, B, K, cg,
                                            fg, chunks, chunk_rows, vec,
                                            stream, nullptr, 1, Bt);
}

// The packed forms: bins (F, N/2) nibble-packed bytes, N even, B <= 16.
int hist_leaves_q8_p4(const void* bins, const void* wch, const void* ch,
                      void* out, int F, long long N, int B, int K, int cg,
                      int fg, int chunks, long long chunk_rows, int vec,
                      void* stream) {
  return launch<int8_t, true>(bins, wch, ch, out, F, N, B, K, cg, fg,
                              chunks, chunk_rows, vec, stream);
}

int hist_leaves_fx_p4(const void* bins, const void* w, const void* ch,
                      void* out, int F, long long N, int B, int K, int cg,
                      int fg, int chunks, long long chunk_rows, int vec,
                      void* stream) {
  return launch<long long, true>(bins, w, ch, out, F, N, B, K, cg, fg,
                                 chunks, chunk_rows, vec, stream);
}

// The model-axis forms (the reference's vmap of the entry points above,
// the batch axis a leading grid dimension): L lanes share the bins and
// each has its own weights and channels.  lanes: device (2, L) int64
// table [weight pointer of lane l, channel pointer of lane l]; out
// (L, K, F, B, 3), zero-filled by the caller; vec: every lane's ch is
// 4-byte aligned.  Grid (combos, chunks, L): lane l's blocks are the
// single form's blocks on its inputs, so each lane's sums are the single
// launch's, bit for bit.
int hist_leaves_q8_lanes(const void* bins, const void* lanes, void* out,
                         int L, int F, long long N, int B, int K, int cg,
                         int fg, int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  return packed ? launch<int8_t, true>(bins, nullptr, nullptr, out, F, N, B,
                                       K, cg, fg, chunks, chunk_rows, vec,
                                       stream, t, L)
                : launch<int8_t, false>(bins, nullptr, nullptr, out, F, N, B,
                                        K, cg, fg, chunks, chunk_rows, vec,
                                        stream, t, L);
}

int hist_leaves_fx_lanes(const void* bins, const void* lanes, void* out,
                         int L, int F, long long N, int B, int K, int cg,
                         int fg, int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  return packed ? launch<long long, true>(bins, nullptr, nullptr, out, F, N,
                                          B, K, cg, fg, chunks, chunk_rows,
                                          vec, stream, t, L)
                : launch<long long, false>(bins, nullptr, nullptr, out, F, N,
                                           B, K, cg, fg, chunks, chunk_rows,
                                           vec, stream, t, L);
}

}  // extern "C"

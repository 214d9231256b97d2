// Single-leaf histogram for the partitioned grower, quantized leaf renewal
// and the autotune probe, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py behind
// build_histogram_pallas (:471): _hist_kernel (the BlockSpec form, :210)
// and _hist_kernel_dma (the DMA form, :327), including the DMA form's
// nibble-packed bins (packed=True, behind bins_packed=True).  All compute
// one leaf's (F, B, 3) histogram (sum g*mask, sum h*mask, count) by
// one-hot MXU contractions of bf16 hi+lo weights; the TPU has no fast
// scatter.  Hopper has shared-memory atomics, so this is the scatter-add
// itself.
//
// Weights are 64-bit fixed point with one power-of-two scale per channel
// per tree (ops/histogram.py pack_weights), as in hist_leaves.cu, so the
// sums are integers: the result does not depend on the order in which
// atomics land, equals the plain version bit for bit, and a parent minus
// its smaller child is exact.  CONTRACT: the count row is pack_weights'
// strict 0/1 membership; each block sums it in 32 bits (at most 2^31 rows
// per block, ops/histogram_cuda.py single_geometry), exactly.
//
// Layouts.  The bins are an (F, n) view with ANY two strides (sf, sn),
// the weights a (3, n) int64 view whose rows are contiguous:
//   * ROWS (sn != 1): the partitioned grower's segment P[s:e, :F].T of its
//     row-major, leaf-contiguous rows (sf = 1, sn = the row width), read
//     in place.  Each row's features of the block's group are one
//     contiguous byte run: read as 4-byte words when sf = 1 and every
//     row's run starts 4-byte aligned (`words`), byte by byte otherwise
//     (unaligned heads, a ragged last group, any other strides).
//   * FEATS (sn == 1): a feature-major (F, n) matrix (renewal's (1, N)
//     row->leaf column, the autotune probe), 4 rows per 32-bit load when
//     aligned; the packed form reads the autotuner's (F, N/2)
//     nibble-packed bytes (row 2j in the low nibble of byte j, row 2j+1
//     in the high one), 4 rows per 16-bit load.
//
// What bounds it on the H100: bytes.  Per row it reads 24 bytes of
// weights and, for rows that add, F bin bytes: 0.49 GB, 0.146 ms at 3.35
// TB/s for the partitioned root (F=28, 10.5M rows, 80% in the bag).  The
// work is 3 shared atomics per (row, feature): 706M at that shape.
//
// Design (what the first version lost time on, PERF.md section 6):
//  1. Fill the SMs on every segment.  The grid is (row chunks, feature
//     groups); single_geometry sizes it from the SM count and the
//     segment's rows: long segments run all features in one block per
//     SM (one resident round), short ones split the features into more
//     groups and the rows into chunks of at least SINGLE_MIN_ROWS, so a
//     100K-row child still spreads over the card; blocks whose shared
//     histogram is small (F=1 renewal, one-feature groups) run 4 to an
//     SM at 256 threads.  The first version gave a segment n/4096 blocks.
//  2. Rows in flight.  A thread takes 2 rows per step (ROWS: their
//     weights, then up to 8 words of each row's run, all loads issued
//     before the adds) or 4 (FEATS: one load per feature for all 4).
//  3. Lanes on different features.  Lane l starts its row's features at
//     word (or feature) l mod the group's count and wraps, so a warp's
//     atomics land on ~8 features at once: a feature with 3 bins (Higgs'
//     b-tags) or a segment cut to a few bins of its split features no
//     longer puts 32 lanes on one address.  Each feature's histogram
//     starts (B | 1) entries after the last, so equal bins of different
//     features fall in different banks.
//  4. The count in 32 bits: B x 20 bytes per feature (int64 g and h,
//     uint32 count), 144 KB at F=28, B=256; one 32-bit atomic of three.
// Each block zero-fills its histogram, walks its chunk, and flushes the
// non-zero entries into the (F, B, 3) int64 result with global atomics.
//
// Times (CUDA events behind a spinning kernel, chip_smoke.py phase 2 at
// the partitioned root: F=28, N=10,502,144 row-major rows, B=256; NVIDIA
// H100 80GB HBM3, 700.00 W): hist_single 1.722 ms (the first version
// 3.692 ms on the same timer, one index_add_ of the same sums 17.6);
// hist_single_p4 at B=16 1.848 ms (3.423); one partitioned iteration's
// 255 launches 20.5 ms of kernel time (107.0, torch.profiler).
// PERF.md section 6 has the readings behind each part of the design.
//
// uint16 bin codes (max_bin > 255; the reference serves them by its XLA
// one-hot histogram, lightgbm_tpu/learner/serial.py:564-570, with no
// Pallas form): the same kernels templated on the bin type.  ROWS reads a
// row's run as words of 2 features, FEATS 4 rows per 64-bit load.  A
// feature takes (B | 1) x 20 bytes: past ~11,600 bins one feature no
// longer fits a block, so the grid has a BIN-TILE axis: the block of
// tile t keeps bins [t * Bt, t * Bt + Bt) of its feature group and drops
// every other row's add (single_geometry picks Bt; the uint8 forms run
// one tile of B).  Each extra tile re-reads the chunk's rows: 2 bytes a
// (row, feature) and the row's 24 weight bytes per tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerStep = 2;   // ROWS: rows of one thread per step
constexpr int kWordsAhead = 8;    // ROWS: words of a row loaded at once

struct Hist {
  unsigned long long* g;
  unsigned long long* h;
  unsigned int* c;
  int S;   // entries per feature: B | 1
};

__device__ __forceinline__ void add(const Hist& H, int e, long long g,
                                    long long h, unsigned int c) {
  if (g) atomicAdd(H.g + e, (unsigned long long)g);
  if (h) atomicAdd(H.h + e, (unsigned long long)h);
  if (c) atomicAdd(H.c + e, c);
}

// Zero-fill the block's histogram of nf features, nbt bins each.
__device__ __forceinline__ Hist zero_hist(unsigned char* smem, int nf,
                                          int nbt) {
  Hist H;
  H.S = nbt | 1;
  const int E = nf * H.S;
  H.g = reinterpret_cast<unsigned long long*>(smem);
  H.h = H.g + E;
  H.c = reinterpret_cast<unsigned int*>(H.h + E);
  for (int i = threadIdx.x; i < 2 * E; i += blockDim.x) H.g[i] = 0ULL;
  for (int i = threadIdx.x; i < E; i += blockDim.x) H.c[i] = 0u;
  __syncthreads();
  return H;
}

// Flush: entry (k, b) of the tile [b0, b0 + nbt) ->
// out[((f0 + k) * B + b0 + b) * 3 + 0..2].
__device__ __forceinline__ void flush(const Hist& H, unsigned long long* out,
                                     int f0, int nf, int B, int b0,
                                     int nbt) {
  __syncthreads();
  for (int i = threadIdx.x; i < nf * nbt; i += blockDim.x) {
    const int k = i / nbt;
    const int b = i - k * nbt;
    const int e = k * H.S + b;
    unsigned long long* o = out + ((long long)(f0 + k) * B + b0 + b) * 3;
    if (H.g[e]) atomicAdd(o, H.g[e]);
    if (H.h[e]) atomicAdd(o + 1, H.h[e]);
    if (H.c[e]) atomicAdd(o + 2, (unsigned long long)H.c[e]);
  }
}

// The model-axis form: lane blockIdx.z's segment from the device table
// (4, L) [bins pointer, weights pointer, rows, weight row stride] and its
// (F, B, 3) slice of the (L, F, B, 3) result.  A block past its lane's
// rows walks none and flushes nothing.
#define LANE_INPUTS()                                               \
  do {                                                              \
    const int z_ = blockIdx.z;                                      \
    bins = reinterpret_cast<const BT*>(lanes[z_]);                  \
    w = reinterpret_cast<const long long*>(lanes[L + z_]);          \
    n = lanes[2 * L + z_];                                          \
    ws = lanes[3 * L + z_];                                         \
    out += (long long)z_ * F * B * 3;                               \
  } while (0)

// Block row y of the grid: feature group y / tiles, bin tile y % tiles.
struct Tile {
  int f0, nf, b0, nbt;
};

__device__ __forceinline__ Tile tile_of(int F, int B, int fg, int Bt) {
  const int tiles = (B + Bt - 1) / Bt;
  const int fgi = blockIdx.y / tiles;
  Tile t;
  t.f0 = fgi * fg;
  t.nf = min(fg, F - t.f0);
  t.b0 = (blockIdx.y - fgi * tiles) * Bt;
  t.nbt = min(Bt, B - t.b0);
  return t;
}

// ROWS: block (x, y) takes rows [x * chunk_rows, ...) and features
// [y * fg, ...).  words: sf == 1 and every row's run of the group's
// features starts 4-byte aligned (fg a multiple of 4, or one group).
// The bins are uint8 or uint16 codes (BT); a 32-bit word holds kPer
// features of a row's run.  Bt: bins per tile (B for one tile).
template <typename BT>
__global__ void __launch_bounds__(1024)
hist_single_rows(const BT* __restrict__ bins, long long sf,
                 long long sn, const long long* __restrict__ w, long long ws,
                 unsigned long long* __restrict__ out, int F, long long n,
                 int B, int fg, int Bt, long long chunk_rows, int words,
                 const long long* __restrict__ lanes, int L) {
  constexpr int kPer = 4 / (int)sizeof(BT);
  constexpr int kBits = 8 * (int)sizeof(BT);
  constexpr unsigned int kMask = (1u << kBits) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {
    LANE_INPUTS();
    words = words && (reinterpret_cast<uintptr_t>(bins) & 3) == 0;
  }
  const Tile T = tile_of(F, B, fg, Bt);
  const int f0 = T.f0, nf = T.nf, b0 = T.b0;
  const unsigned int nbt = (unsigned int)T.nbt;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(n, r0 + chunk_rows);
  const Hist H = zero_hist(smem, nf, T.nbt);
  const int lane = threadIdx.x & 31;
  const int nw = words ? nf / kPer : 0;   // whole words of a row's run
  const int nb = nf - kPer * nw;          // features read one by one
  const long long step = (long long)blockDim.x * kRowsPerStep;

  for (long long t = r0 + threadIdx.x; t < r1; t += step) {
    long long g[kRowsPerStep], h[kRowsPerStep];
    unsigned int c[kRowsPerStep];
    const BT* p[kRowsPerStep];
    bool in[kRowsPerStep], live[kRowsPerStep];
#pragma unroll
    for (int i = 0; i < kRowsPerStep; ++i) {
      const long long r = t + i * (long long)blockDim.x;
      in[i] = r < r1;
      g[i] = in[i] ? __ldg(w + r) : 0;
      h[i] = in[i] ? __ldg(w + ws + r) : 0;
      c[i] = in[i] ? (unsigned int)__ldg(w + 2 * ws + r) : 0u;
      p[i] = bins + r * sn + (long long)f0 * sf;
    }
    // the bins load with the weights (not after them); the adds skip rows
    // whose weights are all zero
#pragma unroll
    for (int i = 0; i < kRowsPerStep; ++i)
      live[i] = in[i] && ((g[i] | h[i]) != 0 || c[i] != 0u);
    // whole words, up to kWordsAhead per round, lane-rotated
    for (int u = 0; u < nw; u += kWordsAhead) {
      const int cnt = min(kWordsAhead, nw - u);
      const int start = lane % cnt;
      unsigned int v[kRowsPerStep][kWordsAhead];
#pragma unroll
      for (int i = 0; i < kRowsPerStep; ++i) {
        int q = start;
#pragma unroll
        for (int s = 0; s < kWordsAhead; ++s) {
          v[i][s] = (s < cnt && in[i])
                        ? __ldg(reinterpret_cast<const unsigned int*>(
                              p[i] + kPer * (u + q)))
                        : 0u;
          q = q + 1 == cnt ? 0 : q + 1;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerStep; ++i) {
        if (!live[i]) continue;
        int q = start;
#pragma unroll
        for (int s = 0; s < kWordsAhead; ++s) {
          if (s < cnt) {
            const int k0 = kPer * (u + q);
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const unsigned int b =
                  ((v[i][s] >> (kBits * j)) & kMask) - (unsigned int)b0;
              if (b < nbt) add(H, (k0 + j) * H.S + b, g[i], h[i], c[i]);
            }
          }
          q = q + 1 == cnt ? 0 : q + 1;
        }
      }
    }
    // the features left (all of them without words), lane-rotated
    if (nb > 0) {
      const int kb = kPer * nw;
      int q = lane % nb;
      for (int s = 0; s < nb; ++s) {
        const int k = kb + q;
        unsigned int b[kRowsPerStep];
#pragma unroll
        for (int i = 0; i < kRowsPerStep; ++i)
          b[i] = in[i] ? (unsigned int)__ldg(p[i] + k * sf) - (unsigned int)b0
                       : nbt;
#pragma unroll
        for (int i = 0; i < kRowsPerStep; ++i)
          if (live[i] && b[i] < nbt)
            add(H, k * H.S + b[i], g[i], h[i], c[i]);
        q = q + 1 == nb ? 0 : q + 1;
      }
    }
  }
  flush(H, out, f0, nf, B, b0, T.nbt);
}

// FEATS: 4 consecutive rows per thread; block (x, y) takes rows
// [x * chunk_rows, ...) (a multiple of 16) and features [y * fg, ...).
// PACKED: bins are (F, n/2) nibble-packed bytes, sf bytes per feature.
// vec: the 4 rows' bins of a feature are one aligned 32-bit (uint8),
// 64-bit (uint16) or 16-bit (packed) word.  BT: uint8 or uint16 codes
// (PACKED: uint8 bytes of two codes).
template <typename BT, bool PACKED>
__global__ void __launch_bounds__(1024)
hist_single_feats(const BT* __restrict__ bins, long long sf,
                  const long long* __restrict__ w, long long ws,
                  unsigned long long* __restrict__ out, int F, long long n,
                  int B, int fg, int Bt, long long chunk_rows, int vec,
                  const long long* __restrict__ lanes, int L) {
  constexpr bool kWide = sizeof(BT) == 2;
  constexpr int kBits = 8 * (int)sizeof(BT);
  constexpr unsigned int kMask = (1u << kBits) - 1u;
  // the 4 rows' codes of one feature
  using VT = typename std::conditional<kWide, unsigned long long,
                                       unsigned int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {
    LANE_INPUTS();
    vec = vec && (reinterpret_cast<uintptr_t>(bins) & (kWide ? 7 : 3)) == 0;
  }
  const Tile T = tile_of(F, B, fg, Bt);
  const int f0 = T.f0, nf = T.nf, b0 = T.b0;
  const unsigned int nbt = (unsigned int)T.nbt;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(n, r0 + chunk_rows);
  const Hist H = zero_hist(smem, nf, T.nbt);
  const int lane = threadIdx.x & 31;
  const BT* col0 = bins + (long long)f0 * sf;

  for (long long r = r0 + 4LL * threadIdx.x; r < r1;
       r += 4LL * blockDim.x) {
    long long g[4], h[4];
    unsigned int c[4];
    unsigned int act = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = r + i < r1;
      g[i] = in ? __ldg(w + r + i) : 0;
      h[i] = in ? __ldg(w + ws + r + i) : 0;
      c[i] = in ? (unsigned int)__ldg(w + 2 * ws + r + i) : 0u;
      if ((g[i] | h[i]) != 0 || c[i] != 0u) act |= 1u << i;
    }
    if (!act) continue;
    const bool whole = vec && r + 4 <= r1;
    int q = lane % nf;
    for (int s = 0; s < nf; s += 4) {
      VT v[4];
      int kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {   // four features' loads together
        kk[a] = q;
        q = q + 1 == nf ? 0 : q + 1;
        v[a] = 0u;
        if (s + a >= nf) continue;
        const BT* col = col0 + kk[a] * sf;
        if constexpr (PACKED) {
          if (whole) {
            v[a] = __ldg(reinterpret_cast<const unsigned short*>(
                col + (r >> 1)));
          } else {
            for (int i = 0; i < 4 && r + i < r1; i += 2)
              v[a] |= (unsigned int)__ldg(col + ((r + i) >> 1)) << (4 * i);
          }
        } else if constexpr (kWide) {
          if (whole) {
            const uint2 x = __ldg(reinterpret_cast<const uint2*>(col + r));
            v[a] = (VT)x.x | ((VT)x.y << 32);
          } else {
            for (int i = 0; i < 4 && r + i < r1; ++i)
              v[a] |= (VT)__ldg(col + r + i) << (16 * i);
          }
        } else {
          if (whole) {
            v[a] = __ldg(reinterpret_cast<const unsigned int*>(col + r));
          } else {
            for (int i = 0; i < 4 && r + i < r1; ++i)
              v[a] |= (unsigned int)__ldg(col + r + i) << (8 * i);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (s + a >= nf) continue;
        const int base = kk[a] * H.S;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!((act >> i) & 1u)) continue;
          const unsigned int b =
              (PACKED ? (unsigned int)(v[a] >> (4 * i)) & 15u
                      : (unsigned int)(v[a] >> (kBits * i)) & kMask) -
              (unsigned int)b0;
          if (b < nbt) add(H, base + b, g[i], h[i], c[i]);
        }
      }
    }
  }
  flush(H, out, f0, nf, B, b0, T.nbt);
}

size_t smem_bytes(int fg, int Bt) { return (size_t)fg * (Bt | 1) * 20; }

// Dynamic shared memory above 48 KB, and the whole L1 carveout as shared
// memory so that four small blocks fit an SM.
template <typename K>
int prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

// One launch of the uint8 or uint16 form: grid (chunks, f_groups x tiles),
// Bt bins per tile; layout as in hist_single below.
template <typename BT>
int launch_single(const void* bins, long long sf, long long sn,
                  const void* w, long long ws, void* out, int F, long long n,
                  int B, int fg, int Bt, int chunks, long long chunk_rows,
                  int threads, int layout, void* stream) {
  if (F <= 0 || n <= 0) return 0;
  if (Bt <= 0 || Bt > B) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)((F + fg - 1) / fg) * ((B + Bt - 1) / Bt);
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(fg, Bt);
  const dim3 grid(chunks, (unsigned int)rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BT* b = static_cast<const BT*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<BT>, smem)) != 0) return err;
    hist_single_rows<BT><<<grid, threads, smem, st>>>(
        b, sf, sn, wp, ws, o, F, n, B, fg, Bt, chunk_rows, layout == 1,
        nullptr, 1);
  } else {
    if ((err = prepare(hist_single_feats<BT, false>, smem)) != 0) return err;
    hist_single_feats<BT, false><<<grid, threads, smem, st>>>(
        b, sf, wp, ws, o, F, n, B, fg, Bt, chunk_rows, layout == 3, nullptr,
        1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (F, B, 3) int64 histogram of fixed-point weights, accumulated into `out`
// (zero-filled by the caller).  Strides are in elements: bins[f * sf + r *
// sn] is feature f of row r, w[k * ws + r] weight channel k of row r.
// Grid (chunks, ceil(F / fg)) of `threads`; layout 0: ROWS, 1: ROWS with
// words, 2: FEATS (sn == 1), 3: FEATS with aligned 32-bit loads.
int hist_single(const void* bins, long long sf, long long sn, const void* w,
                long long ws, void* out, int F, long long n, int B, int fg,
                int chunks, long long chunk_rows, int threads, int layout,
                void* stream) {
  return launch_single<uint8_t>(bins, sf, sn, w, ws, out, F, n, B, fg, B,
                                chunks, chunk_rows, threads, layout, stream);
}

// The uint16 form (max_bin > 255): bins are uint16 codes, strides in
// elements; the grid's rows are ceil(F / fg) feature groups x
// ceil(B / Bt) bin tiles (group-major); layout 1 reads words of 2
// features (every run 4-byte aligned), layout 3 4 rows per 64-bit load
// (the bins 8-byte aligned, sf a multiple of 4).
int hist_single_u16(const void* bins, long long sf, long long sn,
                    const void* w, long long ws, void* out, int F,
                    long long n, int B, int fg, int Bt, int chunks,
                    long long chunk_rows, int threads, int layout,
                    void* stream) {
  return launch_single<uint16_t>(bins, sf, sn, w, ws, out, F, n, B, fg, Bt,
                                 chunks, chunk_rows, threads, layout, stream);
}

// The packed form: bins (F, nb) contiguous nibble-packed bytes (N = 2 * nb
// rows), w (3, N) contiguous int64, B <= 16; accumulated into `out`
// (F, B, 3) int64, zero-filled by the caller.  chunk_rows in rows.
int hist_single_p4(const void* bins, const void* w, void* out, int F,
                   long long nb, int B, int fg, int chunks,
                   long long chunk_rows, int threads, int vec, void* stream) {
  if (F <= 0 || nb <= 0) return 0;
  const size_t smem = smem_bytes(fg, B);
  int err;
  if ((err = prepare(hist_single_feats<uint8_t, true>, smem)) != 0)
    return err;
  const dim3 grid(chunks, (F + fg - 1) / fg);
  hist_single_feats<uint8_t, true><<<grid, threads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), nb, static_cast<const long long*>(w),
      2 * nb, static_cast<unsigned long long*>(out), F, 2 * nb, B, fg, B,
      chunk_rows, vec, nullptr, 1);
  return (int)cudaGetLastError();
}

// The model-axis form (the reference's vmap of build_histogram_pallas,
// uint8 and packed):
// L lanes' segments, each with its own bins view, weights and row count,
// all with the strides (sf, sn) and F features.  lanes: device (4, L)
// int64 table [bins pointer, weights pointer, rows, weight row stride];
// out (L, F, B, 3) int64, zero-filled by the caller.  Grid (chunks,
// ceil(F / fg), L), the chunks sized for the longest segment; layout as
// in hist_single, word and 32-bit loads taken per lane where its bins
// pointer is 4-byte aligned; layout 4 is the packed form (each lane's bins
// (F, nb) contiguous nibble-packed bytes, sf = nb, its rows 2 * nb; the
// reference's vmap of build_histogram_pallas(bins_packed=True), :446),
// layout 5 the same with 16-bit loads, taken per lane where its bins
// pointer is 4-byte aligned.
// Lane l's blocks are the single form's blocks on its segment, so its
// sums are the single launch's, bit for bit.
int hist_single_lanes(const void* lanes, long long sf, long long sn,
                      void* out, int L, int F, int B, int fg, int chunks,
                      long long chunk_rows, int threads, int layout,
                      void* stream) {
  if (F <= 0 || L <= 0) return 0;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(fg, B);
  const dim3 grid(chunks, (F + fg - 1) / fg, L);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(lanes);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint8_t>, smem)) != 0) return err;
    hist_single_rows<uint8_t><<<grid, threads, smem, st>>>(
        nullptr, sf, sn, nullptr, 0, o, F, 0, B, fg, B, chunk_rows,
        layout == 1, t, L);
  } else if (layout < 4) {
    if ((err = prepare(hist_single_feats<uint8_t, false>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, false><<<grid, threads, smem, st>>>(
        nullptr, sf, nullptr, 0, o, F, 0, B, fg, B, chunk_rows, layout == 3,
        t, L);
  } else {
    if ((err = prepare(hist_single_feats<uint8_t, true>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, true><<<grid, threads, smem, st>>>(
        nullptr, sf, nullptr, 0, o, F, 0, B, fg, B, chunk_rows, layout == 5,
        t, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

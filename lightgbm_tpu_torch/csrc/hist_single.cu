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
// feature takes (Bt | 1) x 20 bytes: past 11,621 bins one feature no
// longer fits a block, so its bins split into `tiles` tiles of Bt.  The
// uint16 form runs every launch as thread-block clusters of `cs` blocks
// (cs a multiple of tiles, at most 16): cluster y holds the fgc =
// (cs / tiles) x fg features [y * fgc, ...), its block of rank r keeps
// features (r / tiles) x fg .. + fg of them and the bins of residue
// r % tiles (bins t, t + tiles, ...: a feature whose codes crowd into a
// low range still spreads over the cluster) in shared memory and walks
// 1/cs of the cluster's rows, reading each row's weights and its fgc
// codes once.  So a row is read once per
// cluster, not once per tile and feature group (the first uint16 form
// re-read it per tile: 168 times at B=65,535 and F=28).  Each code adds
// into the block that keeps its bin: its own histogram; the histogram of
// one of the `peers` ranks after its own, through distributed shared
// memory (DSM); or, for the other ranks, the output itself, with global
// atomics that L2 serves.  On the H100 a DSM add costs about six local
// ones, an L2 add on spread codes a little less but far more on a few hot
// bins, and the two run side by side, so a block sends half its remote
// adds each way.  Past one tile a feature takes 8 tiles and a cluster of
// 16 blocks holds two features (8 peers), so a row's weights are read
// once per two features: the masked grower's launches over every row,
// most of them weightless, read more than they add.  One block is a
// cluster of one (B <= 11,621, where the sweep keeps every add local).
// single_shape (ops/histogram_cuda.py) picks cs, peers and fg once per
// (SM count, F, B, layout), single_chunks the row chunks from the rows,
// filling the clusters resident at once (cudaOccupancyMaxActiveClusters,
// single_resident).  A block's uint32 counts sum
// the rows of its whole cluster: at most 2^31 (single_geometry).  The
// uint8 forms never tile and run one block a cluster, with no cluster
// code.  PERF.md section 6 has the sweep behind these choices.  The
// model-axis uint16 form (hist_single_lanes_u16) runs the same clusters
// with the lane as grid z, each lane's row chunks its single launch's
// (ops/histogram_cuda.py lane_single_u16_geometry): a chunk length sized
// for all lanes' rows as one segment left most blocks of a long lane's
// cluster idle and the rest walking twice the rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerStep = 2;   // ROWS: rows of one thread per step
constexpr int kWordsAhead = 8;    // ROWS: words of a row loaded at once
constexpr int kMaxCluster = 16;   // H100, non-portable cluster sizes

struct Hist {
  unsigned long long* g;
  unsigned long long* h;
  unsigned int* c;
  int S;   // entries per feature: Bt | 1
  int E;   // entries per channel: fg * S
};

__device__ __forceinline__ void add(const Hist& H, int e, long long g,
                                    long long h, unsigned int c) {
  if (g) atomicAdd(H.g + e, (unsigned long long)g);
  if (h) atomicAdd(H.h + e, (unsigned long long)h);
  if (c) atomicAdd(H.c + e, c);
}

// Zero-fill the block's histogram of fg features, Bt bins each (the same
// layout in every block of a cluster); the caller syncs.
__device__ __forceinline__ Hist zero_hist(unsigned char* smem, int fg,
                                          int Bt) {
  Hist H;
  H.S = Bt | 1;
  H.E = fg * H.S;
  H.g = reinterpret_cast<unsigned long long*>(smem);
  H.h = H.g + H.E;
  H.c = reinterpret_cast<unsigned int*>(H.h + H.E);
  for (int i = threadIdx.x; i < 2 * H.E; i += blockDim.x) H.g[i] = 0ULL;
  for (int i = threadIdx.x; i < H.E; i += blockDim.x) H.c[i] = 0u;
  return H;
}

// Every block of the cluster (CL), or the block's threads, at one point.
template <bool CL>
__device__ __forceinline__ void sync_all() {
  if constexpr (CL) cg::this_cluster().sync();
  else __syncthreads();
}

// Flush: entry (k, b) of the tile of bins b0 + b * step (b < nbt) ->
// out[((f0 + k) * B + b0 + b * step) * 3 + 0..2].  After sync_all.
__device__ __forceinline__ void flush(const Hist& H, unsigned long long* out,
                                     int f0, int nf, int B, int b0,
                                     int nbt, int step) {
  for (int i = threadIdx.x; i < nf * nbt; i += blockDim.x) {
    const int k = i / nbt;
    const int b = i - k * nbt;
    const int e = k * H.S + b;
    unsigned long long* o =
        out + ((long long)(f0 + k) * B + b0 + (long long)b * step) * 3;
    if (H.g[e]) atomicAdd(o, H.g[e]);
    if (H.h[e]) atomicAdd(o + 1, H.h[e]);
    if (H.c[e]) atomicAdd(o + 2, (unsigned long long)H.c[e]);
  }
}

// The model-axis form: lane blockIdx.z's segment from the device table
// (5, L) [bins pointer, weights pointer, rows, weight row stride, rows a
// block] and its (F, B, 3) slice of the (L, F, B, 3) result.  A block past
// its lane's rows walks none and flushes nothing.
#define LANE_INPUTS()                                               \
  do {                                                              \
    const int z_ = blockIdx.z;                                      \
    bins = reinterpret_cast<const BT*>(lanes[z_]);                  \
    w = reinterpret_cast<const long long*>(lanes[L + z_]);          \
    n = lanes[2 * L + z_];                                          \
    ws = lanes[3 * L + z_];                                         \
    chunk_rows = lanes[4 * L + z_];                                 \
    out += (long long)z_ * F * B * 3;                               \
  } while (0)

// The block's place: cluster blockIdx.y reads features [g0, g0 + ng) of
// every row it walks; the block keeps features [f0, f0 + nf) (none past
// F) and the nbt bins b0, b0 + tiles, b0 + 2 tiles, ... of them (its
// tile: the bins of one residue mod tiles, so that a feature whose codes
// crowd into a low range still spreads over the cluster).  Without
// clusters (CL false) the block is its own cluster of one tile: it keeps
// what it reads.
struct Place {
  int g0, ng, f0, nf, b0, nbt, rank;
};

template <bool CL>
__device__ __forceinline__ Place place_of(int F, int B, int fg, int Bt,
                                          int tiles, int cs) {
  Place p;
  if constexpr (!CL) {
    p.rank = 0;
    p.g0 = p.f0 = blockIdx.y * fg;
    p.ng = p.nf = min(fg, F - p.g0);
    p.b0 = 0;
    p.nbt = B;
    return p;
  }
  p.rank = (int)cg::this_cluster().block_rank();
  const int fgc = (cs / tiles) * fg;
  p.g0 = blockIdx.y * fgc;
  p.ng = min(fgc, F - p.g0);
  p.f0 = p.g0 + (p.rank / tiles) * fg;
  p.nf = max(0, min(fg, F - p.f0));
  p.b0 = p.rank % tiles;
  p.nbt = (B - p.b0 + tiles - 1) / tiles;   // at most Bt
  return p;
}

// x / d for x < 2^16 and 1 <= d <= 2^16, with m = 2^32 / d + 1 (d > 1):
// the error of x * m / 2^32 is below x / 2^32 < 1 / d, so the floor is
// exact.
__device__ __forceinline__ unsigned int quot(unsigned int x, unsigned int d,
                                             unsigned int m) {
  return d == 1u ? x : __umulhi(x, m);
}

__host__ __device__ __forceinline__ unsigned int magic(unsigned int d) {
  return d <= 1u ? 0u : (unsigned int)(0x100000000ULL / d + 1ULL);
}

// Where the adds of the cluster's feature k (0 <= k < ng) go.  Without
// clusters: bin v at entry k * S + v of the block's own histogram.  With
// them, to the block that keeps the bin, rank r = (k / fg) * tiles +
// v % tiles of the cluster, entry (k % fg) * S + v / tiles there: its own
// histogram; a peer's through DSM when r is one of the `peers` ranks
// after the block's own (cyclically); else straight into the output,
// out[((g0 + k) * B + v) * 3], with global atomics that L2 serves.  A
// DSM add costs about six local ones on the H100, and DSM and L2 atomics
// are separate paths: splitting the remote adds between them beats
// either alone (PERF.md section 6).  Codes at or past B add nothing, as
// in the plain version.  The histogram is the kernel's own `Hist`
// (zero_hist's), passed by reference: holding a copy of it in another
// object faulted on the card.
struct Route {
  unsigned int B, fg, mfg, tiles, mtl, cs, peers;
  int rank;
};

__device__ __forceinline__ Route route(int B, int fg, int tiles, int cs,
                                       int peers, int rank) {
  Route R;
  R.B = (unsigned int)B;
  R.fg = (unsigned int)fg;
  R.mfg = magic((unsigned int)fg);
  R.tiles = (unsigned int)tiles;
  R.mtl = magic((unsigned int)tiles);
  R.cs = (unsigned int)cs;
  R.peers = (unsigned int)peers;
  R.rank = rank;
  return R;
}

template <bool CL>
__device__ __forceinline__ void put(const Hist& H, const Route& R,
                                    unsigned long long* og, int k,
                                    unsigned int v, long long g, long long h,
                                    unsigned int c) {
  if (v >= R.B) return;
  if constexpr (!CL) {
    add(H, k * H.S + (int)v, g, h, c);
  } else {
    const unsigned int fs = quot((unsigned int)k, R.fg, R.mfg);
    const unsigned int j = quot(v, R.tiles, R.mtl);
    const int e = (int)(((unsigned int)k - fs * R.fg) * (unsigned int)H.S +
                        j);
    const int r = (int)(fs * R.tiles + (v - j * R.tiles));
    const unsigned int d =
        (unsigned int)(r - R.rank) + (r < R.rank ? R.cs : 0u);
    if (d == 0u) {
      add(H, e, g, h, c);
    } else if (d <= R.peers) {
      Hist P = H;
      P.g = cg::this_cluster().map_shared_rank(H.g, r);
      P.h = P.g + H.E;
      P.c = reinterpret_cast<unsigned int*>(P.h + H.E);
      add(P, e, g, h, c);
    } else {
      unsigned long long* o = og + ((long long)k * R.B + v) * 3;
      if (g) atomicAdd(o, (unsigned long long)g);
      if (h) atomicAdd(o + 1, (unsigned long long)h);
      if (c) atomicAdd(o + 2, (unsigned long long)c);
    }
  }
}

// ROWS: block (x, y) takes rows [x * chunk_rows, ...) of cluster y's
// features.  words: sf == 1 and every row's run of the cluster's
// features starts 4-byte aligned (fgc even for uint16, a multiple of 4
// for uint8, or one group).  The bins are uint8 or uint16 codes (BT; the
// uint16 form runs as clusters); a 32-bit word holds kPer features of a
// row's run.
template <typename BT>
__global__ void __launch_bounds__(1024)
hist_single_rows(const BT* __restrict__ bins, long long sf,
                 long long sn, const long long* __restrict__ w, long long ws,
                 unsigned long long* __restrict__ out, int F, long long n,
                 int B, int fg, int Bt, int cs, int peers,
                 long long chunk_rows, int words,
                 const long long* __restrict__ lanes, int L) {
  constexpr bool CL = sizeof(BT) == 2;
  constexpr int kPer = 4 / (int)sizeof(BT);
  constexpr int kBits = 8 * (int)sizeof(BT);
  constexpr unsigned int kMask = (1u << kBits) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {
    LANE_INPUTS();
    words = words && (reinterpret_cast<uintptr_t>(bins) & 3) == 0;
  }
  const int tiles = CL ? (B + Bt - 1) / Bt : 1;
  const Place P = place_of<CL>(F, B, fg, Bt, tiles, cs);
  const int ng = P.ng;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(n, r0 + chunk_rows);
  const Hist H = zero_hist(smem, fg, Bt);
  sync_all<CL>();   // every histogram of the cluster zeroed
  const Route R = route(B, fg, tiles, cs, peers, P.rank);
  unsigned long long* og = out + (long long)P.g0 * B * 3;
  const int lane = threadIdx.x & 31;
  const int nw = words ? ng / kPer : 0;   // whole words of a row's run
  const int nb = ng - kPer * nw;          // features read one by one
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
      p[i] = bins + r * sn + (long long)P.g0 * sf;
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
            for (int j = 0; j < kPer; ++j)
              put<CL>(H, R, og, k0 + j, (v[i][s] >> (kBits * j)) & kMask, g[i],
                      h[i], c[i]);
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
          b[i] = in[i] ? (unsigned int)__ldg(p[i] + k * sf) : 0u;
#pragma unroll
        for (int i = 0; i < kRowsPerStep; ++i)
          if (live[i]) put<CL>(H, R, og, k, b[i], g[i], h[i], c[i]);
        q = q + 1 == nb ? 0 : q + 1;
      }
    }
  }
  sync_all<CL>();   // every add of the cluster landed
  flush(H, out, P.f0, P.nf, B, P.b0, P.nbt, tiles);
}

// FEATS: 4 consecutive rows per thread; block (x, y) takes rows
// [x * chunk_rows, ...) (a multiple of 16) of cluster y's features.
// PACKED: bins are (F, n/2) nibble-packed bytes, sf bytes per feature.
// vec: the 4 rows' bins of a feature are one aligned 32-bit (uint8),
// 64-bit (uint16) or 16-bit (packed) word.  BT: uint8 or uint16 codes
// (PACKED: uint8 bytes of two codes); the uint16 form runs as clusters.
template <typename BT, bool PACKED>
__global__ void __launch_bounds__(1024)
hist_single_feats(const BT* __restrict__ bins, long long sf,
                  const long long* __restrict__ w, long long ws,
                  unsigned long long* __restrict__ out, int F, long long n,
                  int B, int fg, int Bt, int cs, int peers,
                  long long chunk_rows, int vec,
                  const long long* __restrict__ lanes, int L) {
  constexpr bool kWide = sizeof(BT) == 2;
  constexpr bool CL = kWide && !PACKED;
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
  const int tiles = CL ? (B + Bt - 1) / Bt : 1;
  const Place P = place_of<CL>(F, B, fg, Bt, tiles, cs);
  const int ng = P.ng;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min(n, r0 + chunk_rows);
  const Hist H = zero_hist(smem, fg, Bt);
  sync_all<CL>();   // every histogram of the cluster zeroed
  const Route R = route(B, fg, tiles, cs, peers, P.rank);
  unsigned long long* og = out + (long long)P.g0 * B * 3;
  const int lane = threadIdx.x & 31;
  const BT* col0 = bins + (long long)P.g0 * sf;

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
    int q = lane % ng;
    for (int s = 0; s < ng; s += 4) {
      VT v[4];
      int kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {   // four features' loads together
        kk[a] = q;
        q = q + 1 == ng ? 0 : q + 1;
        v[a] = 0u;
        if (s + a >= ng) continue;
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
        if (s + a >= ng) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!((act >> i) & 1u)) continue;
          put<CL>(H, R, og, kk[a],
                  PACKED ? (unsigned int)(v[a] >> (4 * i)) & 15u
                         : (unsigned int)(v[a] >> (kBits * i)) & kMask,
                  g[i], h[i], c[i]);
        }
      }
    }
  }
  sync_all<CL>();   // every add of the cluster landed
  flush(H, out, P.f0, P.nf, B, P.b0, P.nbt, tiles);
}

size_t smem_bytes(int fg, int Bt) { return (size_t)fg * (Bt | 1) * 20; }

// Dynamic shared memory above 48 KB, and the whole L1 carveout as shared
// memory so that four small blocks fit an SM; clusters past the 8 blocks
// of the portable limit.
template <typename K>
int prepare(K kernel, size_t smem, int cs = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || cs <= 8) return (int)err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// One launch of the uint8 form: grid (chunks, feature groups), one tile
// of B bins, no clusters; layout as in hist_single below.
int launch_u8(const void* bins, long long sf, long long sn, const void* w,
              long long ws, void* out, int F, long long n, int B, int fg,
              int chunks, long long chunk_rows, int threads, int layout,
              void* stream) {
  if (F <= 0 || n <= 0) return 0;
  const size_t smem = smem_bytes(fg, B);
  const dim3 grid(chunks, (F + fg - 1) / fg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint8_t>, smem)) != 0) return err;
    hist_single_rows<uint8_t><<<grid, threads, smem, st>>>(
        b, sf, sn, wp, ws, o, F, n, B, fg, B, 1, 0, chunk_rows, layout == 1,
        nullptr, 1);
  } else {
    if ((err = prepare(hist_single_feats<uint8_t, false>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, false><<<grid, threads, smem, st>>>(
        b, sf, wp, ws, o, F, n, B, fg, B, 1, 0, chunk_rows, layout == 3,
        nullptr, 1);
  }
  return (int)cudaGetLastError();
}

// The launch configuration of the uint16 form: grid (chunks, feature
// groups) in clusters of (cs, 1, 1).
struct U16Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

int u16_config(U16Launch* L, int F, int B, int fg, int Bt, int cs,
               int chunks, int threads, void* stream) {
  if (fg <= 0 || Bt <= 0 || Bt > B || B > 65536 || cs <= 0 ||
      cs > kMaxCluster || threads <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + Bt - 1) / Bt;
  if (cs % tiles != 0 || chunks % cs != 0 || fg * (cs / tiles) > 65535)
    return (int)cudaErrorInvalidValue;
  const int fgc = fg * (cs / tiles);
  const int groups = (F + fgc - 1) / fgc;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3((unsigned int)chunks, (unsigned int)groups);
  L->cfg.blockDim = dim3((unsigned int)threads);
  L->cfg.dynamicSmemBytes = smem_bytes(fg, Bt);
  L->cfg.stream = static_cast<cudaStream_t>(stream);
  L->attr[0].id = cudaLaunchAttributeClusterDimension;
  L->attr[0].val.clusterDim.x = (unsigned int)cs;
  L->attr[0].val.clusterDim.y = 1;
  L->attr[0].val.clusterDim.z = 1;
  L->cfg.attrs = L->attr;
  L->cfg.numAttrs = 1;
  return 0;
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
  return launch_u8(bins, sf, sn, w, ws, out, F, n, B, fg, chunks, chunk_rows,
                   threads, layout, stream);
}

// The uint16 form (max_bin > 255): bins are uint16 codes, strides in
// elements.  Grid (chunks, ceil(F / fgc)) of `threads` in clusters of cs
// blocks, fgc = (cs / tiles) x fg features a cluster, tiles = ceil(B /
// Bt), cs a multiple of tiles and chunks of cs; chunk_rows rows a block
// (the blocks of a cluster take consecutive chunks); a block's adds for
// the `peers` ranks after its own (0 <= peers < cs) go through DSM, its
// other remote adds into `out` through L2.  Layout 1 reads
// words of 2 features (every run of a cluster's features 4-byte
// aligned), layout 3 4 rows per 64-bit load (the bins 8-byte aligned, sf
// a multiple of 4).
int hist_single_u16(const void* bins, long long sf, long long sn,
                    const void* w, long long ws, void* out, int F,
                    long long n, int B, int fg, int Bt, int cs, int peers,
                    int chunks, long long chunk_rows, int threads,
                    int layout, void* stream) {
  if (F <= 0 || n <= 0) return 0;
  if (peers < 0 || peers >= cs) return (int)cudaErrorInvalidValue;
  U16Launch L;
  int err = u16_config(&L, F, B, fg, Bt, cs, chunks, threads, stream);
  if (err != 0) return err;
  const size_t smem = L.cfg.dynamicSmemBytes;
  const uint16_t* b = static_cast<const uint16_t*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const long long* none = nullptr;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint16_t>, smem, cs)) != 0)
      return err;
    err = (int)cudaLaunchKernelEx(&L.cfg, hist_single_rows<uint16_t>, b, sf,
                                  sn, wp, ws, o, F, n, B, fg, Bt, cs,
                                  peers, chunk_rows, (int)(layout == 1),
                                  none, 1);
  } else {
    if ((err = prepare(hist_single_feats<uint16_t, false>, smem, cs)) != 0)
      return err;
    err = (int)cudaLaunchKernelEx(&L.cfg, hist_single_feats<uint16_t, false>,
                                  b, sf, wp, ws, o, F, n, B, fg, Bt, cs,
                                  peers, chunk_rows, (int)(layout == 3),
                                  none, 1);
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// Clusters of the uint16 form resident on the current device at once
// (cudaOccupancyMaxActiveClusters) for clusters of cs blocks of `threads`
// threads and fg features x Bt bins each; layout < 2 the ROWS kernel,
// else FEATS.  A negative value is minus the CUDA error.
int hist_single_u16_clusters(int B, int fg, int Bt, int cs, int threads,
                             int layout) {
  U16Launch L;
  int err = u16_config(&L, 1, B, fg, Bt, cs, cs, threads, nullptr);
  if (err != 0) return -err;
  const size_t smem = L.cfg.dynamicSmemBytes;
  int clusters = 0;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint16_t>, smem, cs)) != 0)
      return -err;
    err = (int)cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)hist_single_rows<uint16_t>, &L.cfg);
  } else {
    if ((err = prepare(hist_single_feats<uint16_t, false>, smem, cs)) != 0)
      return -err;
    err = (int)cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)hist_single_feats<uint16_t, false>, &L.cfg);
  }
  return err != 0 ? -err : clusters;
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
      2 * nb, static_cast<unsigned long long*>(out), F, 2 * nb, B, fg, B, 1,
      0, chunk_rows, vec, nullptr, 1);
  return (int)cudaGetLastError();
}

// The model-axis form (the reference's vmap of build_histogram_pallas,
// uint8 and packed):
// L lanes' segments, each with its own bins view, weights and row count,
// all with the strides (sf, sn) and F features.  lanes: device (5, L)
// int64 table [bins pointer, weights pointer, rows, weight row stride,
// rows a block]; out (L, F, B, 3) int64, zero-filled by the caller.  Grid
// (chunks, ceil(F / fg), L), the chunks sized for the longest segment;
// layout as in hist_single, word and 32-bit loads taken per lane where its
// bins pointer is 4-byte aligned; layout 4 is the packed form (each lane's
// bins (F, nb) contiguous nibble-packed bytes, sf = nb, its rows 2 * nb; the
// reference's vmap of build_histogram_pallas(bins_packed=True), :446),
// layout 5 the same with 16-bit loads, taken per lane where its bins
// pointer is 4-byte aligned.
// Lane l's blocks are the single form's blocks on its segment, so its
// sums are the single launch's, bit for bit.
int hist_single_lanes(const void* lanes, long long sf, long long sn,
                      void* out, int L, int F, int B, int fg, int chunks,
                      int threads, int layout, void* stream) {
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
        nullptr, sf, sn, nullptr, 0, o, F, 0, B, fg, B, 1, 0, 0LL,
        layout == 1, t, L);
  } else if (layout < 4) {
    if ((err = prepare(hist_single_feats<uint8_t, false>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, false><<<grid, threads, smem, st>>>(
        nullptr, sf, nullptr, 0, o, F, 0, B, fg, B, 1, 0, 0LL,
        layout == 3, t, L);
  } else {
    if ((err = prepare(hist_single_feats<uint8_t, true>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, true><<<grid, threads, smem, st>>>(
        nullptr, sf, nullptr, 0, o, F, 0, B, fg, B, 1, 0, 0LL,
        layout == 5, t, L);
  }
  return (int)cudaGetLastError();
}

// The model-axis form over uint16 codes (the reference's vmap of its XLA
// one-hot histogram at max_bin > 255): hist_single_u16's clusters on each
// of L lanes' segments, the lanes table and result as in
// hist_single_lanes, each lane with its own rows a block (its single
// launch's).  Grid (chunks, ceil(F / fgc), L) in clusters of (cs, 1, 1):
// a cluster lies along the row chunks of one lane and one feature group,
// so it never straddles two lanes; chunks (a multiple of cs) are the most
// any lane takes, and a lane's surplus clusters walk no rows but still
// reach both cluster barriers (no block returns early).  Layout as in
// hist_single_u16, words and 64-bit loads taken per lane where its bins
// pointer is aligned.  Lane l's blocks are the single form's blocks on its
// segment, so its sums are the single launch's.
int hist_single_lanes_u16(const void* lanes, long long sf, long long sn,
                          void* out, int L, int F, int B, int fg, int Bt,
                          int cs, int peers, int chunks, int threads,
                          int layout, void* stream) {
  if (F <= 0 || L <= 0) return 0;
  if (L > 65535 || peers < 0 || peers >= cs)
    return (int)cudaErrorInvalidValue;
  U16Launch C;
  int err = u16_config(&C, F, B, fg, Bt, cs, chunks, threads, stream);
  if (err != 0) return err;
  C.cfg.gridDim.z = (unsigned int)L;
  const size_t smem = C.cfg.dynamicSmemBytes;
  const long long* t = static_cast<const long long*>(lanes);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const uint16_t* none = nullptr;
  const long long* nw = nullptr;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint16_t>, smem, cs)) != 0)
      return err;
    err = (int)cudaLaunchKernelEx(&C.cfg, hist_single_rows<uint16_t>, none,
                                  sf, sn, nw, 0LL, o, F, 0LL, B, fg, Bt, cs,
                                  peers, 0LL, (int)(layout == 1), t, L);
  } else {
    if ((err = prepare(hist_single_feats<uint16_t, false>, smem, cs)) != 0)
      return err;
    err = (int)cudaLaunchKernelEx(&C.cfg, hist_single_feats<uint16_t, false>,
                                  none, sf, nw, 0LL, o, F, 0LL, B, fg, Bt,
                                  cs, peers, 0LL, (int)(layout == 3), t, L);
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// What bounds it on the H100.  The bytes: per row 24 bytes of weights
// and, for rows that add, F bin bytes: 0.49 GB, 0.146 ms at 3.35 TB/s for
// the partitioned root (F=28, 10.5M rows, 80% in the bag).  What the card
// spends its time on is the adds: 3 shared atomics per (row, feature),
// 706M at that shape.  sm_90a has no native 64-bit shared atomicAdd: it
// compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64: a load, the
// add, a CAS and a retry branch), which spins on every hot bin.  A probe
// that loads and decodes every code but adds nothing takes half of the
// time at B=256, so the adds, not the loads, set the pace: a ring of bulk
// asynchronous copies (cp.async.bulk, mbarrier completion) feeding the
// adding warps ran slower than each thread's own loads, which 32 warps a
// block already keep in flight (PERF.md section 6).
//
// Design (PERF.md section 6 has the readings behind each part):
//  1. Native adds.  The uint8 forms add each 64-bit weight with one
//     atomic through a generic address (ATOM.E.ADD.64 on the shared
//     window; its SASS keeps a compare-and-swap fallback behind a
//     predicate the atomic sets, and at 2.6x the loop's speed it is the
//     native path that runs).  The uint16 forms, whose loops are at the
//     64-register limit of a 1024-thread block and spill with the generic
//     form's 64-bit addresses, add two native 32-bit shared atomics
//     (ATOMS.ADD): the low half returns its old value, and its carry goes
//     with the high half, exact mod 2^64, so the sums stay bitwise.  An
//     entry that DSM reductions also reach (past one tile) takes only
//     64-bit reductions (put).
//  2. Fill the SMs on every segment.  A single launch's grid is (row
//     chunks, feature groups); single_geometry sizes it from the SM count
//     and the segment's rows: long segments run all features in one block
//     per SM, short ones split the features into more groups and the rows
//     into chunks of at least SINGLE_MIN_ROWS; blocks whose shared
//     histogram is small run 4 to an SM at 256 threads.
//  3. The model-axis forms (hist_single_lanes, _u16: the reference's vmap
//     of build_histogram_pallas) run one grid of work items over all
//     lanes (ops/histogram_cuda.py lane_single_items): (lane, feature
//     group, first row, end row), one block (a cluster past one tile)
//     each, so a short lane takes a slot only for the rows it has, an
//     empty one none, and no cluster holds two lanes.
//  4. Rows in flight.  ROWS: a thread takes 2 rows per step (their
//     weights, then up to 8 words of each row's run, all loads issued
//     before the adds; uint16: 4 rows and 2 words); FEATS: 4 rows, one
//     word per feature for all 4, from each span's first aligned row (a
//     lane's or chunk's misaligned head of up to 3 rows read code by
//     code), so every lane takes word loads wherever its segment starts.
//  5. Lanes on different features.  Lane l starts its row's features at
//     word (or feature) l mod the group's count and wraps, so a warp's
//     atomics land on ~8 features at once; each feature's histogram
//     starts (B | 1) entries after the last, so equal bins of different
//     features fall in different banks.
//  6. The count in 32 bits: B x 20 bytes per feature (int64 g and h,
//     uint32 count), 144 KB at F=28, B=256.
// Each block zero-fills its histogram, walks its rows, and adds the
// non-zero entries into the (F, B, 3) int64 result with global
// reductions (red.global: no return, no test for the shared window).
//
// Times (CUDA events behind a spinning kernel, medians of two runs; F=28,
// N=10,502,144, the model-axis forms at L=4 on segments N, N/2, 50,003,
// N/5 of per-lane row-major copies, 80% of the rows in the bag; NVIDIA
// H100 80GB HBM3, 700.00 W; scripts/torch_single_lanes_sweep.py, PERF.md
// section 6): hist_single at the partitioned root 0.668 ms;
// hist_single_lanes 1.132, FEATS 1.385; uint16 at B=1024 ROWS 1.847, FEATS
// 1.748; at 65,535 ROWS 10.591, FEATS 9.954, one index_add_ of the same
// sums 10.682 / 10.680.
//
// uint16 bin codes (max_bin > 255; the reference serves them by its XLA
// one-hot histogram, lightgbm_tpu/learner/serial.py:564-570, with no
// Pallas form): the same kernels templated on the bin type.  ROWS reads a
// row's run as words of 2 features, FEATS 4 rows per 64-bit load.  A
// feature takes (Bt | 1) x 20 bytes: past 11,621 bins one feature no
// longer fits a block, so its bins split into `tiles` tiles of Bt.  The
// uint16 form runs every launch as thread-block clusters of `cs` blocks
// (cs a multiple of tiles, at most 16): the cluster of feature group y
// holds the fgc = (cs / tiles) x fg features [y * fgc, ...), its block of
// rank r keeps features (r / tiles) x fg .. + fg of them and the bins of
// residue r % tiles (bins t, t + tiles, ...: a feature whose codes crowd
// into a low range still spreads over the cluster) in shared memory and
// walks 1/cs of the cluster's rows, reading each row's weights and its
// fgc codes once.  Each code adds into the block that keeps its bin: its
// own histogram or that of one of the `peers` ranks after its own,
// through distributed shared memory (DSM) with no-return reductions
// (red.shared::cluster); or, for the other ranks, the output itself, with
// global reductions that L2 serves.  The DSM and L2 paths run side by
// side, so a block sends half its remote adds each way (8 peers of 16
// ran fastest at 65,535 of 0, 4, 8, 12 and 15).  Staging the remote adds
// and shipping them to their owners in bulk each round ran slower: two
// cluster barriers a round cost more than the remote adds they replaced.
// Past one tile a feature takes 8 tiles and a cluster of 16 blocks holds
// two features (8 peers), so a row's weights are read once per two
// features.  One block is a cluster of one (B <= 11,621).  single_shape
// (ops/histogram_cuda.py) picks cs, peers and fg once per (SM count, F,
// B, layout), single_chunks the row chunks from the rows, filling the
// clusters resident at once (cudaOccupancyMaxActiveClusters,
// single_resident).  A block's uint32 counts sum the rows of its whole
// cluster: at most 2^31 (single_geometry, lane_single_items).  The uint8
// forms never tile and run one block a cluster, with no cluster code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// ROWS: rows of one thread per step and words of a row loaded at once,
// for uint8 codes 2 and 8, for uint16 codes 4 and 2: more rows in flight
// for the remote adds past one tile, where a cluster's run is one word
// (PERF.md section 6 has the pairs timed)
template <typename BT>
constexpr int kRowsPerStep = sizeof(BT) == 2 ? 4 : 2;
template <typename BT>
constexpr int kWordsAhead = sizeof(BT) == 2 ? 2 : 8;
constexpr int kMaxCluster = 16;   // H100, non-portable cluster sizes

struct Hist {
  unsigned long long* g;
  unsigned long long* h;
  unsigned int* c;
  int S;   // entries per feature: Bt | 1
  int E;   // entries per channel: fg * S
};

// A 64-bit weight into the block's own shared histogram, never as a
// 64-bit shared atomicAdd (a compare-and-swap loop on sm_90a).  WIDE (the
// uint16 forms, whose loops are tighter on registers: a generic address
// takes two): two native 32-bit shared atomics, the low half returning
// its old value and its carry added with the high half, exact mod 2^64,
// so the sums stay bitwise.  Else one 64-bit atomic through a generic
// address, native on the shared window.  An entry that other blocks reach
// with 64-bit DSM reductions takes no 32-bit halves (put).
template <bool WIDE>
__device__ __forceinline__ void add64(unsigned long long* p, long long v) {
  if constexpr (WIDE) {
    unsigned int* q = reinterpret_cast<unsigned int*>(p);
    const unsigned long long x = (unsigned long long)v;
    const unsigned int lo = (unsigned int)x;
    const unsigned int old = atomicAdd(q, lo);
    const unsigned int up =
        (unsigned int)(x >> 32) + (old + lo < old ? 1u : 0u);
    if (up) atomicAdd(q + 1, up);
  } else {
    unsigned long long* q;
    asm("mov.b64 %0, %1;" : "=l"(q) : "l"(p));   // the state space hidden
    atomicAdd(q, (unsigned long long)v);
  }
}

// Into device memory (the result): a reduction with no return, through
// the global state space (a generic 64-bit atomic also tests for the
// shared window and carries a compare-and-swap loop for it).
__device__ __forceinline__ void red_global(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "l"(v)
               : "memory");
}

// Into the block's own histogram (WIDE: a uint16 form's).
template <bool WIDE>
__device__ __forceinline__ void add(const Hist& H, int e, long long g,
                                    long long h, unsigned int c) {
  if (g) add64<WIDE>(H.g + e, g);
  if (h) add64<WIDE>(H.h + e, h);
  if (c) atomicAdd(H.c + e, c);
}

// Into the histogram of rank r of the cluster through DSM: no-return
// 64-bit (and, for the count, 32-bit) reductions on its shared memory.
__device__ __forceinline__ unsigned int dsm(const void* local, int rank) {
  unsigned int a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"((unsigned int)__cvta_generic_to_shared(local)),
                 "r"(rank));
  return a;
}

__device__ __forceinline__ void add_remote(const Hist& H, int r, int e,
                                           long long g, long long h,
                                           unsigned int c) {
  if (g)
    asm volatile("red.shared::cluster.add.u64 [%0], %1;" ::"r"(
                     dsm(H.g + e, r)),
                 "l"((unsigned long long)g)
                 : "memory");
  if (h)
    asm volatile("red.shared::cluster.add.u64 [%0], %1;" ::"r"(
                     dsm(H.h + e, r)),
                 "l"((unsigned long long)h)
                 : "memory");
  if (c)
    asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(
                     dsm(H.c + e, r)),
                 "r"(c)
                 : "memory");
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
    if (H.g[e]) red_global(o, H.g[e]);
    if (H.h[e]) red_global(o + 1, H.h[e]);
    if (H.c[e]) red_global(o + 2, (unsigned long long)H.c[e]);
  }
}

// The block's rows and feature group.  A single launch: block (x, y) takes
// rows [x * chunk_rows, ...) of group y (the blocks of a cluster take
// consecutive chunks).  The model-axis forms: the cluster's work item
// blockIdx.x / cs of the (I, 4) table [lane, group, first row, end row],
// the item's rows split over the cluster's blocks in 16-row steps (the
// same share for every block), and the item's lane from the (4, L) table
// [bins pointer, weights pointer, rows, weight row stride] with its (F, B,
// 3) slice of the (L, F, B, 3) result.  A cluster never holds two lanes.
template <typename BT>
struct Span {
  const BT* bins;
  const long long* w;
  long long ws, r0, r1, share;
  unsigned long long* out;
  int group;
};

template <typename BT>
__device__ __forceinline__ Span<BT> span_of(
    const BT* bins, const long long* w, long long ws,
    unsigned long long* out, int F, long long n, int B, long long chunk_rows,
    const long long* lanes, const long long* items, int L, int cs,
    int rank) {
  Span<BT> s;
  if (items == nullptr) {
    s.bins = bins;
    s.w = w;
    s.ws = ws;
    s.out = out;
    s.group = (int)blockIdx.y;
    s.r0 = min(n, (long long)blockIdx.x * chunk_rows);
    s.r1 = min(n, s.r0 + chunk_rows);
    s.share = chunk_rows;
    return s;
  }
  const long long* it = items + 4LL * (blockIdx.x / cs);
  const int z = (int)it[0];
  s.bins = reinterpret_cast<const BT*>(lanes[z]);
  s.w = reinterpret_cast<const long long*>(lanes[L + z]);
  s.ws = lanes[3 * L + z];
  s.out = out + (long long)z * F * B * 3;
  s.group = (int)it[1];
  const long long a = it[2], b = it[3];
  s.share = ((b - a + cs - 1) / cs + 15) / 16 * 16;
  s.r0 = min(b, a + (long long)rank * s.share);
  s.r1 = min(b, s.r0 + s.share);
  return s;
}

// The block's place: the cluster of feature group `group` reads features
// [g0, g0 + ng) of every row it walks; the block keeps features [f0, f0 +
// nf) (none past F) and the nbt bins b0, b0 + tiles, b0 + 2 tiles, ... of
// them (its tile: the bins of one residue mod tiles, so that a feature
// whose codes crowd into a low range still spreads over the cluster).
// Without clusters (CL false) the block is its own cluster of one tile: it
// keeps what it reads.
struct Place {
  int g0, ng, f0, nf, b0, nbt;
};

template <bool CL>
__device__ __forceinline__ Place place_of(int F, int B, int fg, int tiles,
                                          int cs, int group, int rank) {
  Place p;
  if constexpr (!CL) {
    p.g0 = p.f0 = group * fg;
    p.ng = p.nf = min(fg, F - p.g0);
    p.b0 = 0;
    p.nbt = B;
    return p;
  }
  const int fgc = (cs / tiles) * fg;
  p.g0 = group * fgc;
  p.ng = min(fgc, F - p.g0);
  p.f0 = p.g0 + (rank / tiles) * fg;
  p.nf = max(0, min(fg, F - p.f0));
  p.b0 = rank % tiles;
  p.nbt = (B - p.b0 + tiles - 1) / tiles;   // at most Bt
  return p;
}

template <bool CL>
__device__ __forceinline__ int rank_of() {
  if constexpr (CL) return (int)cg::this_cluster().block_rank();
  else return 0;
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
// histogram or a peer's, one of the `peers` ranks after the block's own
// (cyclically), through DSM; else straight into the output, out[((g0 + k)
// * B + v) * 3], with global reductions that L2 serves.  DSM (the kernels
// launched with peers, past one tile): the block's own adds go as the same
// DSM reductions as its peers' into its histogram, since PTX makes two
// atomics atomic to each other only where they cover the same bytes, so
// the 32-bit halves of add64<true> must not meet a 64-bit reduction on
// one entry; without peers (one tile) they stay the halves, in kernels
// with no DSM code.  Codes at or past B add nothing, as in
// the plain version.  The histogram is the
// kernel's own `Hist` (zero_hist's), passed by reference: holding a copy
// of it in another object faulted on the card.
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

// (entry, owner rank) of feature k's bin v in a cluster.
__device__ __forceinline__ int owner_of(const Route& R, int S, int k,
                                        unsigned int v, int* e) {
  const unsigned int fs = quot((unsigned int)k, R.fg, R.mfg);
  const unsigned int j = quot(v, R.tiles, R.mtl);
  *e = (int)(((unsigned int)k - fs * R.fg) * (unsigned int)S + j);
  return (int)(fs * R.tiles + (v - j * R.tiles));
}

template <bool CL, bool DSM>
__device__ __forceinline__ void put(const Hist& H, const Route& R,
                                    unsigned long long* og, int k,
                                    unsigned int v, long long g, long long h,
                                    unsigned int c) {
  if (v >= R.B) return;
  if constexpr (!CL) {
    add<CL>(H, k * H.S + (int)v, g, h, c);
  } else {
    int e;
    const int r = owner_of(R, H.S, k, v, &e);
    const unsigned int d =
        (unsigned int)(r - R.rank) + (r < R.rank ? R.cs : 0u);
    if (d <= R.peers) {
      if constexpr (DSM) add_remote(H, r, e, g, h, c);
      else add<CL>(H, e, g, h, c);
    } else {
      unsigned long long* o = og + ((long long)k * R.B + v) * 3;
      if (g) red_global(o, (unsigned long long)g);
      if (h) red_global(o + 1, (unsigned long long)h);
      if (c) red_global(o + 2, (unsigned long long)c);
    }
  }
}

// ROWS: each block walks its span's rows (span_of) for its cluster's
// features.  words: sf == 1 and every row's run of the cluster's features
// starts 4-byte aligned (fgc even for uint16, a multiple of 4 for uint8,
// or one group; the model-axis forms also need the lane's bins pointer
// 4-byte aligned, taken per lane).  The bins are uint8 or uint16 codes
// (BT; the uint16 form runs as clusters); a 32-bit word holds kPer
// features of a row's run.  DSM: launched with peers (put).
template <typename BT, bool DSM = false>
__global__ void __launch_bounds__(1024)
hist_single_rows(const BT* __restrict__ bins_, long long sf,
                 long long sn, const long long* __restrict__ w_, long long ws_,
                 unsigned long long* __restrict__ out_, int F, long long n,
                 int B, int fg, int Bt, int cs, int peers,
                 long long chunk_rows, int words,
                 const long long* __restrict__ lanes,
                 const long long* __restrict__ items, int L) {
  constexpr bool CL = sizeof(BT) == 2;
  constexpr int kPer = 4 / (int)sizeof(BT);
  constexpr int kBits = 8 * (int)sizeof(BT);
  constexpr unsigned int kMask = (1u << kBits) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = rank_of<CL>();
  const Span<BT> sp = span_of<BT>(bins_, w_, ws_, out_, F, n, B, chunk_rows,
                                  lanes, items, L, cs, rank);
  const BT* bins = sp.bins;
  const long long* w = sp.w;
  const long long ws = sp.ws;
  if (items) words = words && (reinterpret_cast<uintptr_t>(bins) & 3) == 0;
  const int tiles = CL ? (B + Bt - 1) / Bt : 1;
  const Place P = place_of<CL>(F, B, fg, tiles, cs, sp.group, rank);
  const int ng = P.ng;
  const long long r0 = sp.r0;
  const long long r1 = sp.r1;
  const Hist H = zero_hist(smem, fg, Bt);
  sync_all<CL>();   // every histogram of the cluster zeroed
  const Route R = route(B, fg, tiles, cs, peers, rank);
  unsigned long long* og = sp.out + (long long)P.g0 * B * 3;
  const int lane = threadIdx.x & 31;
  const int nw = words ? ng / kPer : 0;   // whole words of a row's run
  const int nb = ng - kPer * nw;          // features read one by one
  const long long step = (long long)blockDim.x * kRowsPerStep<BT>;

  for (long long t = r0 + threadIdx.x; t < r1; t += step) {
    long long g[kRowsPerStep<BT>], h[kRowsPerStep<BT>];
    unsigned int c[kRowsPerStep<BT>];
    const BT* p[kRowsPerStep<BT>];
    bool in[kRowsPerStep<BT>], live[kRowsPerStep<BT>];
#pragma unroll
    for (int i = 0; i < kRowsPerStep<BT>; ++i) {
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
    for (int i = 0; i < kRowsPerStep<BT>; ++i)
      live[i] = in[i] && ((g[i] | h[i]) != 0 || c[i] != 0u);
    // whole words, up to kWordsAhead<BT> per round, lane-rotated
    for (int u = 0; u < nw; u += kWordsAhead<BT>) {
      const int cnt = min(kWordsAhead<BT>, nw - u);
      const int start = lane % cnt;
      unsigned int v[kRowsPerStep<BT>][kWordsAhead<BT>];
#pragma unroll
      for (int i = 0; i < kRowsPerStep<BT>; ++i) {
        int q = start;
#pragma unroll
        for (int s = 0; s < kWordsAhead<BT>; ++s) {
          v[i][s] = (s < cnt && in[i])
                        ? __ldg(reinterpret_cast<const unsigned int*>(
                              p[i] + kPer * (u + q)))
                        : 0u;
          q = q + 1 == cnt ? 0 : q + 1;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerStep<BT>; ++i) {
        if (!live[i]) continue;
        int q = start;
#pragma unroll
        for (int s = 0; s < kWordsAhead<BT>; ++s) {
          if (s < cnt) {
            const int k0 = kPer * (u + q);
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              put<CL, DSM>(H, R, og, k0 + j, (v[i][s] >> (kBits * j)) & kMask,
                           g[i], h[i], c[i]);
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
        unsigned int b[kRowsPerStep<BT>];
#pragma unroll
        for (int i = 0; i < kRowsPerStep<BT>; ++i)
          b[i] = in[i] ? (unsigned int)__ldg(p[i] + k * sf) : 0u;
#pragma unroll
        for (int i = 0; i < kRowsPerStep<BT>; ++i)
          if (live[i]) put<CL, DSM>(H, R, og, k, b[i], g[i], h[i], c[i]);
        q = q + 1 == nb ? 0 : q + 1;
      }
    }
  }
  sync_all<CL>();   // every add of the cluster landed
  flush(H, sp.out, P.f0, P.nf, B, P.b0, P.nbt, tiles);
}

// FEATS: 4 consecutive rows per thread; each block walks its span's rows
// (span_of; spans start at multiples of 16 rows) for its cluster's
// features.  PACKED: bins are (F, n/2) nibble-packed bytes, sf bytes per
// feature.  vec: the 4 rows' bins of a feature are one aligned 32-bit
// (uint8), 64-bit (uint16) or 16-bit (packed) word (the model-axis forms
// also need the lane's bins pointer aligned, taken per lane).  BT: uint8
// or uint16 codes (PACKED: uint8 bytes of two codes); the uint16 form
// runs as clusters.  DSM: launched with peers (put).
template <typename BT, bool PACKED, bool DSM = false>
__global__ void __launch_bounds__(1024)
hist_single_feats(const BT* __restrict__ bins_, long long sf,
                  const long long* __restrict__ w_, long long ws_,
                  unsigned long long* __restrict__ out_, int F, long long n,
                  int B, int fg, int Bt, int cs, int peers,
                  long long chunk_rows, int vec,
                  const long long* __restrict__ lanes,
                  const long long* __restrict__ items, int L) {
  constexpr bool kWide = sizeof(BT) == 2;
  constexpr bool CL = kWide && !PACKED;
  constexpr int kBits = 8 * (int)sizeof(BT);
  constexpr unsigned int kMask = (1u << kBits) - 1u;
  // the 4 rows' codes of one feature
  using VT = typename std::conditional<kWide, unsigned long long,
                                       unsigned int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = rank_of<CL>();
  const Span<BT> sp = span_of<BT>(bins_, w_, ws_, out_, F, n, B, chunk_rows,
                                  lanes, items, L, cs, rank);
  const BT* bins = sp.bins;
  const long long* w = sp.w;
  const long long ws = sp.ws;
  if (PACKED && items)
    vec = vec && (reinterpret_cast<uintptr_t>(bins) & 3) == 0;
  const int tiles = CL ? (B + Bt - 1) / Bt : 1;
  const Place P = place_of<CL>(F, B, fg, tiles, cs, sp.group, rank);
  const int ng = P.ng;
  const long long r0 = sp.r0;
  const long long r1 = sp.r1;
  const Hist H = zero_hist(smem, fg, Bt);
  sync_all<CL>();   // every histogram of the cluster zeroed
  const Route R = route(B, fg, tiles, cs, peers, rank);
  unsigned long long* og = sp.out + (long long)P.g0 * B * 3;
  const int lane = threadIdx.x & 31;
  const BT* col0 = bins + (long long)P.g0 * sf;

  // rows r .. r + 3 (those before re); vq: each feature's 4 codes one
  // aligned word
  auto quad = [&](long long r, long long re, bool vq) {
    long long g[4], h[4];
    unsigned int c[4];
    unsigned int act = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = r + i < re;
      g[i] = in ? __ldg(w + r + i) : 0;
      h[i] = in ? __ldg(w + ws + r + i) : 0;
      c[i] = in ? (unsigned int)__ldg(w + 2 * ws + r + i) : 0u;
      if ((g[i] | h[i]) != 0 || c[i] != 0u) act |= 1u << i;
    }
    if (!act) return;
    const bool whole = vq && r + 4 <= re;
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
            for (int i = 0; i < 4 && r + i < re; i += 2)
              v[a] |= (unsigned int)__ldg(col + ((r + i) >> 1)) << (4 * i);
          }
        } else if constexpr (kWide) {
          if (whole) {
            const uint2 x = __ldg(reinterpret_cast<const uint2*>(col + r));
            v[a] = (VT)x.x | ((VT)x.y << 32);
          } else {
            for (int i = 0; i < 4 && r + i < re; ++i)
              v[a] |= (VT)__ldg(col + r + i) << (16 * i);
          }
        } else {
          if (whole) {
            v[a] = __ldg(reinterpret_cast<const unsigned int*>(col + r));
          } else {
            for (int i = 0; i < 4 && r + i < re; ++i)
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
          put<CL, DSM>(H, R, og, kk[a],
                  PACKED ? (unsigned int)(v[a] >> (4 * i)) & 15u
                         : (unsigned int)(v[a] >> (kBits * i)) & kMask,
                  g[i], h[i], c[i]);
        }
      }
    }
  };
  // FEATS: from the first row whose words are aligned (a lane's or a
  // span's misaligned head of up to 3 rows read code by code by thread 0),
  // so that every lane's body takes word loads wherever it starts
  long long rb = r0;
  if constexpr (!PACKED) {
    if (vec) {
      const unsigned int m = (unsigned int)(
          (reinterpret_cast<uintptr_t>(col0 + r0) / sizeof(BT)) & 3u);
      rb = min(r1, r0 + (long long)((4u - m) & 3u));
    }
  }
  if (threadIdx.x == 0 && rb > r0) quad(r0, rb, false);
  for (long long r = rb + 4LL * threadIdx.x; r < r1; r += 4LL * blockDim.x)
    quad(r, r1, vec != 0);
  sync_all<CL>();   // every add of the cluster landed
  flush(H, sp.out, P.f0, P.nf, B, P.b0, P.nbt, tiles);
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

// The uint8 forms: grid (x, y) of `threads`, one tile of B bins, no
// clusters; layout as in hist_single below.  A single launch: x = chunks,
// y = feature groups; the model-axis forms: x = work items, y = 1.
int launch_u8(const void* bins, long long sf, long long sn, const void* w,
              long long ws, void* out, int F, long long n, int B, int fg,
              dim3 grid, long long chunk_rows, int threads, int layout,
              const long long* lanes, const long long* items, int L,
              void* stream) {
  const size_t smem = smem_bytes(fg, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint8_t>, smem)) != 0) return err;
    hist_single_rows<uint8_t><<<grid, threads, smem, st>>>(
        b, sf, sn, wp, ws, o, F, n, B, fg, B, 1, 0, chunk_rows, layout == 1,
        lanes, items, L);
  } else if (layout < 4) {
    if ((err = prepare(hist_single_feats<uint8_t, false>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, false><<<grid, threads, smem, st>>>(
        b, sf, wp, ws, o, F, n, B, fg, B, 1, 0, chunk_rows, layout == 3,
        lanes, items, L);
  } else {
    if ((err = prepare(hist_single_feats<uint8_t, true>, smem)) != 0)
      return err;
    hist_single_feats<uint8_t, true><<<grid, threads, smem, st>>>(
        b, sf, wp, ws, o, F, n, B, fg, B, 1, 0, chunk_rows, layout == 5,
        lanes, items, L);
  }
  return (int)cudaGetLastError();
}

// The launch configuration of the uint16 form: grid (x, groups) in
// clusters of (cs, 1, 1).
struct U16Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

int u16_config(U16Launch* L, int F, int B, int fg, int Bt, int cs,
               long long x, int groups, int threads, void* stream) {
  if (fg <= 0 || Bt <= 0 || Bt > B || B > 65536 || cs <= 0 ||
      cs > kMaxCluster || threads <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + Bt - 1) / Bt;
  if (cs % tiles != 0 || x % cs != 0 || x <= 0 || x > 0x7fffffffLL ||
      fg * (cs / tiles) > 65535 || groups <= 0 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3((unsigned int)x, (unsigned int)groups);
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

// The uint16 form's kernel for the layout, with DSM peers or without.
template <bool DSM>
int launch_u16_as(const U16Launch& C, const uint16_t* b, long long sf,
                  long long sn, const long long* wp, long long ws,
                  unsigned long long* o, int F, long long n, int B, int fg,
                  int Bt, int cs, int peers, long long chunk_rows, int layout,
                  const long long* lanes, const long long* items, int L) {
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint16_t, DSM>,
                       C.cfg.dynamicSmemBytes, cs)) != 0)
      return err;
    return (int)cudaLaunchKernelEx(&C.cfg, hist_single_rows<uint16_t, DSM>,
                                   b, sf, sn, wp, ws, o, F, n, B, fg, Bt, cs,
                                   peers, chunk_rows, (int)(layout == 1),
                                   lanes, items, L);
  }
  if ((err = prepare(hist_single_feats<uint16_t, false, DSM>,
                     C.cfg.dynamicSmemBytes, cs)) != 0)
    return err;
  return (int)cudaLaunchKernelEx(&C.cfg,
                                 hist_single_feats<uint16_t, false, DSM>, b,
                                 sf, wp, ws, o, F, n, B, fg, Bt, cs, peers,
                                 chunk_rows, (int)(layout == 3), lanes, items,
                                 L);
}

// One launch of the uint16 form: the layout's kernel, past one tile its
// remote adds through DSM (peers > 0) and L2.
int launch_u16(const U16Launch& C0, const void* bins, long long sf,
               long long sn, const void* w, long long ws, void* out, int F,
               long long n, int B, int fg, int Bt, int cs, int peers,
               long long chunk_rows, int layout, const long long* lanes,
               const long long* items, int L) {
  U16Launch C = C0;
  C.cfg.attrs = C.attr;
  const uint16_t* b = static_cast<const uint16_t*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const int err =
      peers > 0
          ? launch_u16_as<true>(C, b, sf, sn, wp, ws, o, F, n, B, fg, Bt, cs,
                                peers, chunk_rows, layout, lanes, items, L)
          : launch_u16_as<false>(C, b, sf, sn, wp, ws, o, F, n, B, fg, Bt,
                                 cs, peers, chunk_rows, layout, lanes, items,
                                 L);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// Clusters of the uint16 form's kernel for the layout (with DSM peers or
// without) resident on the current device at once.
template <bool DSM>
int u16_clusters_as(const U16Launch& L, int cs, int layout, int* clusters) {
  const size_t smem = L.cfg.dynamicSmemBytes;
  int err;
  if (layout < 2) {
    if ((err = prepare(hist_single_rows<uint16_t, DSM>, smem, cs)) != 0)
      return err;
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, (const void*)hist_single_rows<uint16_t, DSM>, &L.cfg);
  }
  if ((err = prepare(hist_single_feats<uint16_t, false, DSM>, smem, cs)) !=
      0)
    return err;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)hist_single_feats<uint16_t, false, DSM>,
      &L.cfg);
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
  if (F <= 0 || n <= 0) return 0;
  return launch_u8(bins, sf, sn, w, ws, out, F, n, B, fg,
                   dim3(chunks, (F + fg - 1) / fg), chunk_rows, threads,
                   layout, nullptr, nullptr, 1, stream);
}

// The uint16 form (max_bin > 255): bins are uint16 codes, strides in
// elements.  Grid (chunks, ceil(F / fgc)) of `threads` in clusters of cs
// blocks, fgc = (cs / tiles) x fg features a cluster, tiles = ceil(B /
// Bt), cs a multiple of tiles and chunks of cs; chunk_rows rows a block
// (the blocks of a cluster take consecutive chunks).  At one tile every
// add is the block's own; past one tile a block adds the codes of its own
// bin tile and those of the `peers` ranks after it into their shared
// histograms with DSM reductions, and the rest into `out` with global
// reductions.  Layout 1 reads words of 2 features (every run of a
// cluster's features 4-byte aligned), layout 3 4 rows per 64-bit load (sf
// a multiple of 4), from each block's first row whose 4 codes are an
// 8-byte aligned word (the rows before it code by code).
int hist_single_u16(const void* bins, long long sf, long long sn,
                    const void* w, long long ws, void* out, int F,
                    long long n, int B, int fg, int Bt, int cs, int peers,
                    int chunks, long long chunk_rows, int threads,
                    int layout, void* stream) {
  if (F <= 0 || n <= 0) return 0;
  if (peers < 0 || peers >= cs || fg <= 0 || Bt <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int fgc = fg * (cs / ((B + Bt - 1) / Bt));
  U16Launch L;
  int err = u16_config(&L, F, B, fg, Bt, cs, chunks,
                       fgc > 0 ? (F + fgc - 1) / fgc : 0, threads, stream);
  if (err != 0) return err;
  return launch_u16(L, bins, sf, sn, w, ws, out, F, n, B, fg, Bt, cs, peers,
                    chunk_rows, layout, nullptr, nullptr, 1);
}

// Clusters of the uint16 form resident on the current device at once
// (cudaOccupancyMaxActiveClusters) for clusters of cs blocks of `threads`
// threads and fg features x Bt bins each; layout < 2 the ROWS kernel,
// else FEATS, with DSM peers when cs > 1 (as single_shape launches it).
// A negative value is minus the CUDA error.
int hist_single_u16_clusters(int B, int fg, int Bt, int cs, int threads,
                             int layout) {
  U16Launch L;
  int err = u16_config(&L, 1, B, fg, Bt, cs, cs, 1, threads, nullptr);
  if (err != 0) return -err;
  int clusters = 0;
  err = cs > 1 ? u16_clusters_as<true>(L, cs, layout, &clusters)
               : u16_clusters_as<false>(L, cs, layout, &clusters);
  return err != 0 ? -err : clusters;
}

// The packed form: bins (F, nb) contiguous nibble-packed bytes (N = 2 * nb
// rows), w (3, N) contiguous int64, B <= 16; accumulated into `out`
// (F, B, 3) int64, zero-filled by the caller.  chunk_rows in rows.
int hist_single_p4(const void* bins, const void* w, void* out, int F,
                   long long nb, int B, int fg, int chunks,
                   long long chunk_rows, int threads, int vec, void* stream) {
  if (F <= 0 || nb <= 0) return 0;
  return launch_u8(bins, nb, 1, w, 2 * nb, out, F, 2 * nb, B, fg,
                   dim3(chunks, (F + fg - 1) / fg), chunk_rows, threads,
                   vec ? 5 : 4, nullptr, nullptr, 1, stream);
}

// The model-axis form (the reference's vmap of build_histogram_pallas,
// uint8 and packed): L lanes' segments, each with its own bins view,
// weights and row count, all with the strides (sf, sn) and F features.
// lanes: device int64 table of (4, L) [bins pointer, weights pointer,
// rows, weight row stride] followed by the (I, 4) work items [lane, feature
// group, first row, end row] (ops/histogram_cuda.py lane_single_items: the
// lanes' rows cut into items that fill the resident blocks together, a
// short lane's only for the rows it has); out (L, F, B, 3) int64,
// zero-filled by the caller.  One block an item, of `threads`; layout as
// in hist_single, word and 32-bit loads taken per lane where its bins
// pointer is 4-byte aligned; layout 4 is the packed form (each lane's bins
// (F, nb) contiguous nibble-packed bytes, sf = nb, its rows 2 * nb; the
// reference's vmap of build_histogram_pallas(bins_packed=True), :446),
// layout 5 the same with 16-bit loads, taken per lane where its bins
// pointer is 4-byte aligned.  The int64 sums are order-free, so each
// lane's are its single launch's bit for bit.
int hist_single_lanes(const void* lanes, int items, long long sf,
                      long long sn, void* out, int L, int F, int B, int fg,
                      int threads, int layout, void* stream) {
  if (F <= 0 || L <= 0 || items <= 0) return 0;
  const long long* t = static_cast<const long long*>(lanes);
  return launch_u8(nullptr, sf, sn, nullptr, 0, out, F, 0, B, fg,
                   dim3(items, 1), 0LL, threads, layout, t, t + 4LL * L, L,
                   stream);
}

// The model-axis form over uint16 codes (the reference's vmap of its XLA
// one-hot histogram at max_bin > 255): hist_single_u16's clusters over the
// lanes table and work items of hist_single_lanes, one cluster an item
// (grid items x cs blocks in clusters of cs), so no cluster straddles two
// lanes and no cluster walks none.  Layout as in hist_single_u16, words
// and 64-bit loads taken per lane where its bins pointer is aligned.
int hist_single_lanes_u16(const void* lanes, int items, long long sf,
                          long long sn, void* out, int L, int F, int B,
                          int fg, int Bt, int cs, int peers, int threads,
                          int layout, void* stream) {
  if (F <= 0 || L <= 0 || items <= 0) return 0;
  if (peers < 0 || peers >= cs) return (int)cudaErrorInvalidValue;
  U16Launch C;
  int err = u16_config(&C, F, B, fg, Bt, cs, (long long)items * cs, 1,
                       threads, stream);
  if (err != 0) return err;
  const long long* t = static_cast<const long long*>(lanes);
  return launch_u16(C, nullptr, sf, sn, nullptr, 0, out, F, 0, B, fg, Bt,
                    cs, peers, 0LL, layout, t, t + 4LL * L, L);
}

}  // extern "C"

// Leaf-channel histograms over uint16 bin codes (max_bin > 255) for the
// wave grower, hand-written for Hopper (sm_90a): the channel partition and
// the two histograms that walk its row list.
//
// Replaces, at max_bin > 255, the TPU entry points of
// lightgbm_tpu/ops/histogram_pallas.py (the reference serves uint16 codes
// with XLA there, lightgbm_tpu/learner/wave.py:287-294):
//   * build_histogram_pallas_leaves (:852): 25 leaf channels of
//     (sum g*mask, sum h*mask, count)  ->  hist_leaves_fx_u16;
//   * build_histogram_pallas_leaves_q8 (:1030): 42 leaf channels of int32
//     (sum g_q, sum h_q, count)  ->  hist_leaves_q8_u16.
// The uint8 and packed forms (csrc/hist_leaves.cu) walk every row once
// per block column and queue the rows of their channels.  That suits 256
// bins, where ~20 block columns hold every (channel, feature) pair.  At
// 1024 bins a pair takes 20 KB (fx) of a block's 227 KB, so ~70 columns
// each read all N channel bytes, and at 65,535 bins (bin tiles) ~4,900
// do.  Here the rows are sorted by channel ONCE, and each block walks only
// its own channel's share of that list:
//
//  1. The channel partition (leaf_partition: count, scan, scatter).  It
//     reads the (N,) int8 channel and writes the rows with 0 <= ch < K as
//     one channel-major list of RECORDS, ascending by row within a channel
//     (so a block's gathers walk memory forward and the result is
//     deterministic), and the K + 1 offsets.  A record holds the row's id
//     and its three weights, so that a histogram block reads them in
//     order instead of gathering them once per feature group and tile:
//     fx 32 bytes [g, h, id | n << 32, 0], one whole sector a row (the
//     scattered writes of 24-byte records straddle sectors and took the
//     partition twice as long); q8 8 bytes, id | g << 32 | h << 40 |
//     n << 48 (the weights' bytes).  Each of P blocks owns a run of rows
//     and each of its warps 1/32 of that run; the count pass
//     counts every warp's run per channel, the scan turns the blocks'
//     counts into each block's start in every channel, and each warp
//     places its run's rows in row order (ranks among a step's lanes by
//     ballots).  PERF.md section 6 has the measurements behind the
//     records.
//  2. The list chunks.  The scan also shares S chunk slots out over the
//     channels by their listed rows (s_c = max(1, round(n_c S / total))
//     for a channel with rows), so one channel holding 90% of the rows
//     takes 90% of the slots and every block walks at most about
//     2 total / S rows whatever the mix.  It ranks the slots by the start
//     of their share of the channel, (j / s_c, c): blocks that run
//     together then walk the same stretch of rows in every channel, and
//     the bin sectors one channel's block reads are in L2 for the others'.
//  3. The histogram blocks.  Block b takes column b % columns (bin tiles
//     fastest, then feature groups) of the slot ranked b / columns: one
//     channel, fg features, listed rows [off_c + n_c j / s_c,
//     off_c + n_c (j + 1) / s_c).  Past one block's room for B bins, the
//     tiles of a column form a thread-block cluster: each block keeps
//     bins [b0, b0 + Bt) in shared memory, walks 1/tiles of the slot's
//     records and adds each bin into the tile that holds it, a peer's
//     through distributed shared memory, so each record and bin is read
//     once per feature group, not once per tile.  Its threads take
//     consecutive records (no channel scan, no queue), the next record
//     loading while they gather fg bins (eight loads at a time) and add
//     into shared memory; each block flushes its tile once with global
//     atomics.  A block holds per (feature, bin) 20 bytes fx (int64 g and
//     h, uint32 count) or 12 q8 (int64 (g << 32) + h, uint32 count);
//     ops/histogram_cuda.py list_geometry sizes fg, Bt and S.
//
// The sums are integers, so the result is bit-identical from run to run
// and to the plain versions (ops/histogram_cuda.py *_plain).  q8 adds
// (g, h) as one 64-bit atomic of (g << 32) + h: with at most 2^24 rows per
// block (list_geometry sizes S so that no slot exceeds it),
// |sum h| <= 128 * 2^24 = 2^31, so the low word holds sum h as a signed
// 32-bit value and the high word sum g, with no carry lost.
//
// Times, beside the queue-scan design they replace and one int64
// index_add_ of the same sums: PERF.md section 6 (chip_smoke.py phase
// 15a; the geometry sweep, scripts/torch_u16_leaf_sweep.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;   // 64 registers a thread: one block per SM
constexpr int kMaxK = 64;        // channels the partition takes
constexpr int kKeyBits = 6;      // bits of a channel below kMaxK
constexpr int kAhead = 4;        // partition steps whose loads go together
constexpr int kBatch = 8;        // bin loads of one listed row issued together

__device__ __forceinline__ unsigned int lanes_below() {
  unsigned int m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose key equals this lane's (a key in
// [0, kMaxK), or -1 for none: then 0): one ballot per key bit, cheaper
// than __match_any_sync over many distinct keys.
__device__ __forceinline__ unsigned int same_key(int key) {
  unsigned int peers = __ballot_sync(0xffffffffu, key >= 0);
#pragma unroll
  for (int b = 0; b < kKeyBits; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned int v = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? v : ~v;
  }
  return key >= 0 ? peers : 0u;
}

// Warp v's run of block b's rows: the v-th of 32 equal runs of the
// block's [r0, r1).
__device__ __forceinline__ void warp_run(long long N, long long block_rows,
                                         long long* w0, long long* w1) {
  const long long r0 = (long long)blockIdx.x * block_rows;
  const long long r1 = min(N, r0 + block_rows);
  const long long run = (block_rows + 31) / 32;
  *w0 = min(r1, r0 + (threadIdx.x >> 5) * run);
  *w1 = min(r1, *w0 + run);
}

// wcounts[(b * 32 + v) * K + c]: the rows of channel c in warp v's run of
// block b (shared atomics: a count needs no order); counts[c * P + b]:
// those of the block.
__global__ void __launch_bounds__(kThreads)
part_count(const int8_t* __restrict__ ch, long long N, int K,
           long long block_rows, int* __restrict__ counts,
           int* __restrict__ wcounts) {
  __shared__ int wc[32][kMaxK];
  const int P = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 32 * kMaxK; i += blockDim.x)
    (&wc[0][0])[i] = 0;
  __syncthreads();
  long long w0, w1;
  warp_run(N, block_rows, &w0, &w1);
  for (long long t = w0; t < w1; t += kAhead * 32) {
    int key[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long r = t + i * 32 + lane;
      const int c = r < w1 ? (int)__ldg(ch + r) : -1;
      key[i] = (c >= 0 && c < K) ? c : -1;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (key[i] >= 0) atomicAdd(&wc[warp][key[i]], 1);
  }
  __syncwarp();
  for (int c = lane; c < K; c += 32)
    wcounts[((long long)blockIdx.x * 32 + warp) * K + c] = wc[warp][c];
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    int sum = 0;
    for (int v = 0; v < 32; ++v) sum += wc[v][c];
    counts[c * P + blockIdx.x] = sum;
  }
}

// Inclusive scan of one int per thread over the block; returns the
// block's total in *total.
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return out;
}

// One block.  counts (K, P) -> each (channel, block)'s start in the list
// (exclusive scan, channel-major, through shared memory); offsets
// (K + 1); the slots s_c of each channel out of S; table[rank] =
// (j << 8) | c for slot j of channel c, ranked by (j / s_c, c), -1 past
// the last slot (S + K entries).  One thread a slot: rank = j + the
// slots of every other channel that start before j / s_c (and those that
// start with it, of a lower channel).
__global__ void __launch_bounds__(kThreads)
part_scan(int* __restrict__ counts, int K, int P, int S,
          int* __restrict__ offsets, int* __restrict__ slots,
          int* __restrict__ table) {
  extern __shared__ int cs[];   // counts, K * P
  __shared__ int warp_sums[32];
  __shared__ int s_sh[kMaxK + 1];
  __shared__ int pre[kMaxK + 1];
  const int n = K * P;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cs[i] = counts[i];
  __syncthreads();
  const int seg = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = min(n, (int)threadIdx.x * seg), i1 = min(n, i0 + seg);
  int local = 0;
  for (int i = i0; i < i1; ++i) local += cs[i];
  int total;
  int run = block_scan(local, warp_sums, &total) - local;
  for (int i = i0; i < i1; ++i) {
    const int v = cs[i];
    cs[i] = run;
    run += v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) counts[i] = cs[i];
  for (int c = threadIdx.x; c <= K; c += blockDim.x)
    offsets[c] = c < K ? cs[c * P] : total;
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    const long long nc = (long long)(c + 1 < K ? cs[(c + 1) * P] : total) -
                         cs[c * P];
    int s = 0;
    if (nc > 0) s = (int)max(1LL, (2 * nc * S + total) / (2LL * total));
    s_sh[c] = s;
    slots[c] = s;
  }
  for (int i = threadIdx.x; i < S + K; i += blockDim.x) table[i] = -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0;
    for (int c = 0; c < K; ++c) {
      pre[c] = a;
      a += s_sh[c];
    }
    pre[K] = a;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < pre[K]; u += blockDim.x) {
    int c = 0;
    while (pre[c + 1] <= u) ++c;
    const unsigned int j = u - pre[c], sc = s_sh[c];
    unsigned int rank = j;
    for (int d = 0; d < K; ++d) {
      const unsigned int sd = s_sh[d];
      if (d == c || sd == 0) continue;
      const unsigned int q = j * sd;
      rank += (q + sc - 1) / sc + (d < c && q % sc == 0);
    }
    table[rank] = (int)((j << 8) | c);
  }
}

// A listed row: its id and weights.  fx records are (4,) int64, q8
// records one int64 (see the head of this file).
struct Entry {
  long long row, g, h;
  unsigned int n;
};

template <typename W>
__device__ __forceinline__ Entry load_record(const long long* rec,
                                             long long p) {
  Entry e;
  if constexpr (sizeof(W) == 1) {
    const long long r = __ldg(rec + p);
    e.row = r & 0xffffffffLL;
    e.g = (signed char)(r >> 32);
    e.h = (signed char)(r >> 40);
    e.n = (unsigned int)(int)(signed char)(r >> 48);
  } else {
    const longlong2* q = reinterpret_cast<const longlong2*>(rec + 4 * p);
    const longlong2 a = __ldg(q), b = __ldg(q + 1);
    e.g = a.x;
    e.h = a.y;
    e.row = b.x & 0xffffffffLL;
    e.n = (unsigned int)(b.x >> 32);
  }
  return e;
}

template <typename W>
__device__ __forceinline__ void store_record(long long* rec, long long p,
                                             long long row, const W* wv) {
  if constexpr (sizeof(W) == 1) {
    rec[p] = row | ((long long)(unsigned char)wv[0] << 32) |
             ((long long)(unsigned char)wv[1] << 40) |
             ((long long)(unsigned char)wv[2] << 48);
  } else {
    longlong2* q = reinterpret_cast<longlong2*>(rec + 4 * p);
    q[0] = make_longlong2(wv[0], wv[1]);
    q[1] = make_longlong2(row | (wv[2] << 32), 0LL);
  }
}

// Block b's rows in row order to their records, with the weights of w
// (3, N).  Warp v of the block walks the v-th of its 32 runs: a prefix of
// the runs' counts (part_count) over the warps, from the block's start in
// each channel (part_scan), gives its first place in every channel; it
// then takes its run in row order, 32 rows a step, placing each row at
// its channel's next place plus its rank among the step's lanes of that
// channel (ballots).  One block barrier.
template <typename W>
__global__ void __launch_bounds__(kThreads)
part_scatter(const int8_t* __restrict__ ch, const W* __restrict__ w,
             long long N, int K, long long block_rows,
             const int* __restrict__ starts,
             const int* __restrict__ wcounts, long long* __restrict__ rec) {
  __shared__ int wpos[32][kMaxK];   // each warp's next place per channel
  const int P = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int cc = warp; cc < K; cc += 32) {
    const int v = wcounts[((long long)blockIdx.x * 32 + lane) * K + cc];
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    wpos[lane][cc] = starts[cc * P + blockIdx.x] + incl - v;
  }
  __syncthreads();
  long long w0, w1;
  warp_run(N, block_rows, &w0, &w1);
  const unsigned int below = lanes_below();
  int* next = wpos[warp];
  for (long long t = w0; t < w1; t += kAhead * 32) {
    int key[kAhead];
    W wv[kAhead][3];   // the listed rows' weights, loaded ahead
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long r = t + i * 32 + lane;
      const int c = r < w1 ? (int)__ldg(ch + r) : -1;
      key[i] = (c >= 0 && c < K) ? c : -1;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long r = t + i * 32 + lane;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        wv[i][q] = key[i] >= 0 ? __ldg(w + q * N + r) : W(0);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const unsigned int peers = same_key(key[i]);
      long long pos = 0;
      if (key[i] >= 0) pos = next[key[i]] + __popc(peers & below);
      __syncwarp();
      if (key[i] >= 0 && (peers & below) == 0) next[key[i]] += __popc(peers);
      __syncwarp();
      if (key[i] >= 0)
        store_record<W>(rec, pos, t + i * 32 + lane, wv[i]);
    }
  }
}

// Block b: the slot ranked b / columns and column b % columns (tile
// fastest).  The `tiles` blocks of one (slot, feature group), one a bin
// tile, form a thread-block cluster: each keeps its tile's histogram in
// shared memory, walks 1/tiles of the slot's records, and adds each bin
// into the tile that holds it, its own or a peer's through distributed
// shared memory.  So every record and bin is read once per feature group,
// whatever the tiles.  bins: (F, N) uint16 feature-major; rec: the
// partition's records.  out: (K, F, B, 3), int32 (q8) or int64 (fx).
template <typename W>
__global__ void __launch_bounds__(kThreads)
hist_list_kernel(const uint16_t* __restrict__ bins,
                 const long long* __restrict__ rec,
                 const int* __restrict__ offsets,
                 const int* __restrict__ slots,
                 const int* __restrict__ table, void* __restrict__ out,
                 int F, long long N, int B, int fg, int Bt, int tiles,
                 int f_groups) {
  constexpr bool Q8 = sizeof(W) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int columns = f_groups * tiles;
  // the same slot for the whole cluster: it returns or syncs together
  const int slot = table[blockIdx.x / columns];
  if (slot < 0) return;   // a rank no channel took
  const int c = slot & 255, j = slot >> 8;
  const int col = blockIdx.x % columns;
  const int tile = col % tiles;   // == cluster.block_rank()
  const int b0 = tile * Bt;
  const int f0 = (col / tiles) * fg;
  const int nf = min(fg, F - f0);
  const int nbt = min(Bt, B - b0);
  const long long oc = offsets[c], nc = offsets[c + 1] - oc;
  const long long sc = slots[c];
  const long long s0 = oc + nc * j / sc, s1 = oc + nc * (j + 1) / sc;
  const long long p0 = s0 + (s1 - s0) * tile / tiles;
  const long long p1 = s0 + (s1 - s0) * (tile + 1) / tiles;
  const int E = fg * Bt;
  // fx: int64 g[E], int64 h[E]; q8: int64 (g << 32) + h [E]; then uint32
  // count[E].  Entry (k, b) = k * Bt + b - b0 in the tile of b.
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* cnt_acc =
      reinterpret_cast<unsigned int*>(acc + (Q8 ? E : 2 * E));
  for (int i = threadIdx.x; i < (Q8 ? E : 2 * E); i += blockDim.x)
    acc[i] = 0ULL;
  for (int i = threadIdx.x; i < E; i += blockDim.x) cnt_acc[i] = 0u;
  if (tiles > 1) cluster.sync();   // every peer's histogram zeroed
  else __syncthreads();

  // each thread takes every blockDim-th record, the next one loading
  // while this one's bins load and add
  const uint16_t* col0 = bins + (long long)f0 * N;
  long long p = p0 + threadIdx.x;
  Entry nx{0, 0, 0, 0u};
  if (p < p1) nx = load_record<W>(rec, p);
  for (; p < p1; p += blockDim.x) {
    Entry e = nx;
    if (p + blockDim.x < p1) nx = load_record<W>(rec, p + blockDim.x);
    if ((e.g | e.h) == 0 && e.n == 0u) continue;
    unsigned long long gh = 0ULL;
    if constexpr (Q8) gh = (unsigned long long)((e.g << 32) + e.h);
    for (int k = 0; k < nf; k += kBatch) {
      int b[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        b[i] = k + i < nf ? (int)__ldg(col0 + (k + i) * N + e.row) : B;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (b[i] >= B) continue;   // outside the histogram, as in plain
        const int t = tiles == 1 ? 0 : b[i] / Bt;
        const int x = (k + i) * Bt + b[i] - t * Bt;
        unsigned long long* a = acc;
        unsigned int* n = cnt_acc;
        if (t != tile) {   // a peer's tile
          a = cluster.map_shared_rank(acc, t);
          n = cluster.map_shared_rank(cnt_acc, t);
        }
        if constexpr (Q8) {
          if (gh) atomicAdd(a + x, gh);
        } else {
          if (e.g) atomicAdd(a + x, (unsigned long long)e.g);
          if (e.h) atomicAdd(a + E + x, (unsigned long long)e.h);
        }
        if (e.n) atomicAdd(n + x, e.n);
      }
    }
  }
  if (tiles > 1) cluster.sync();   // every peer's adds landed
  else __syncthreads();

  // flush: entry (k, b) -> out[(c * F + f0 + k) * B + b0 + b]
  for (int i = threadIdx.x; i < nf * nbt; i += blockDim.x) {
    const int b = i % nbt;
    const int k = i / nbt;
    const int x = k * Bt + b;
    const long long o = (((long long)c * F + f0 + k) * B + b0 + b) * 3;
    const unsigned int n = cnt_acc[x];
    if constexpr (Q8) {
      const unsigned long long a = acc[x];
      const int hs = (int)(unsigned int)(a & 0xffffffffULL);
      const int gs = (int)((long long)(a - (unsigned long long)(long long)hs)
                           >> 32);
      int* o32 = static_cast<int*>(out) + o;
      if (gs) atomicAdd(o32, gs);
      if (hs) atomicAdd(o32 + 1, hs);
      if (n) atomicAdd(o32 + 2, (int)n);
    } else {
      unsigned long long* o64 = static_cast<unsigned long long*>(out) + o;
      if (acc[x]) atomicAdd(o64, acc[x]);
      if (acc[E + x]) atomicAdd(o64 + 1, acc[E + x]);
      if (n) atomicAdd(o64 + 2, (unsigned long long)n);
    }
  }
}

template <typename W>
int partition(const void* ch, const void* w, long long N, int K, int P,
              int S, void* rec, void* plan, void* stream) {
  if (N <= 0 || K <= 0) return 0;
  if (K > kMaxK || P <= 0 || S <= 0 || N > 0x7fffffffLL ||
      (long long)K * P * sizeof(int) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // plan: offsets (K + 1) | slots (K) | table (S + K) | counts (K x P) |
  // the warps' runs' counts (P x 32 x K)
  int* offsets = static_cast<int*>(plan);
  int* slots = offsets + K + 1;
  int* table = slots + K;
  int* counts = table + S + K;
  int* wcounts = counts + K * P;
  const long long block_rows = (N + P - 1) / P;
  const size_t scan_smem = (size_t)K * P * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      part_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const int8_t* c8 = static_cast<const int8_t*>(ch);
  part_count<<<P, kThreads, 0, s>>>(c8, N, K, block_rows, counts, wcounts);
  part_scan<<<1, kThreads, scan_smem, s>>>(counts, K, P, S, offsets, slots,
                                           table);
  part_scatter<W><<<P, kThreads, 0, s>>>(
      c8, static_cast<const W*>(w), N, K, block_rows, counts, wcounts,
      static_cast<long long*>(rec));
  return (int)cudaGetLastError();
}

template <typename W>
int hist_list(const void* bins, const void* rec, const void* plan, void* out,
              int F, long long N, int B, int K, int fg, int Bt, int S,
              void* stream) {
  if (F <= 0 || N <= 0 || K <= 0) return 0;
  if (fg <= 0 || Bt <= 0 || Bt > B || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + Bt - 1) / Bt;
  const int f_groups = (F + fg - 1) / fg;
  const size_t smem = (size_t)fg * Bt * (sizeof(W) == 1 ? 12 : 20);
  cudaError_t err = cudaFuncSetAttribute(
      hist_list_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int* offsets = static_cast<const int*>(plan);
  const int* slots = offsets + K + 1;
  const int* table = slots + K;
  const long long blocks = (long long)f_groups * tiles * (S + K);
  if (blocks > 0x7fffffffLL || tiles > 8) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;   // a cluster: the tiles of a column
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, hist_list_kernel<W>, static_cast<const uint16_t*>(bins),
      static_cast<const long long*>(rec), offsets, slots, table, out, F, N,
      B, fg, Bt, tiles, f_groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The channel partition: ch (N,) int8; w (3, N) weight rows (wbytes 8:
// int64 fx, 1: int8 q8, the first three rows of the (8, N) wch); rec the
// records, (N, 4) int64 (fx) or (N,) int64 (q8), the first offsets[K]
// written; plan int32 (K + 1) + K + (S + K) + 33 K P, written whole.  P
// row blocks, S chunk slots.  N < 2^31, K <= 64.
int leaf_partition(const void* ch, const void* w, int wbytes, long long N,
                   int K, int P, int S, void* rec, void* plan, void* stream) {
  return wbytes == 1
             ? partition<int8_t>(ch, w, N, K, P, S, rec, plan, stream)
             : partition<long long>(ch, w, N, K, P, S, rec, plan, stream);
}

// The histograms over the partition's records: bins (F, N) uint16; rec
// and plan from leaf_partition; out (K, F, B, 3) zero-filled by the
// caller, int64 (fx) or int32 (q8); fg features and Bt bins per block; S
// the partition's slots.
int hist_leaves_fx_u16(const void* bins, const void* rec, const void* plan,
                       void* out, int F, long long N, int B, int K, int fg,
                       int Bt, int S, void* stream) {
  return hist_list<long long>(bins, rec, plan, out, F, N, B, K, fg, Bt, S,
                              stream);
}

int hist_leaves_q8_u16(const void* bins, const void* rec, const void* plan,
                       void* out, int F, long long N, int B, int K, int fg,
                       int Bt, int S, void* stream) {
  return hist_list<int8_t>(bins, rec, plan, out, F, N, B, K, fg, Bt, S,
                           stream);
}

}  // extern "C"

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
//  1. The channel partition (leaf_partition: count, then scatter).  It reads
//     the (N,) int8 channel and writes the rows with 0 <= ch < K as one
//     channel-major list of RECORDS, ascending by row within a channel (so a
//     block's gathers walk memory forward and the result is deterministic),
//     and the K + 1 offsets.  A record holds the row's id and its three
//     weights, so that a histogram block reads them in order instead of
//     gathering them once per feature group and tile: fx 32 bytes [g, h, id |
//     n << 32, 0], one whole sector a row; q8 8 bytes, id | g << 32 | h << 40
//     | n << 48 (the weights' bytes).  Each of P blocks owns a run of rows (a
//     multiple of 16).  The count pass reads 16 rows a load and counts each
//     block's rows per channel in counters of its own thread (no add waits on
//     another lane's).  The scatter's blocks each sum those counts into their
//     own start in every channel (block 0 also writes offsets, slots and
//     table, 2. below: no one-block kernel between the two launches), then
//     walk their run in tiles (q8 4,096 rows, fx 2,048): the tile's channels
//     (and q8 weights) arrive in shared memory by 16-byte loads issued a tile
//     ahead; each warp ranks its rows within their channel (__match_any_sync,
//     one shared add per channel a step, never one a row); the tile's records
//     are staged in shared memory, channel-sorted; and consecutive threads
//     write consecutive records of each channel's run, so a run leaves in
//     whole lines.  The design it replaced (count, a one-block scan, scatter)
//     stored each row's record at its channel's next place, a warp's 32
//     stores in ~32 runs (a quarter sector each at q8), and lost to one
//     stable torch.sort of the channels.  PERF.md section 6 has the
//     measurements (scripts/torch_partition_sweep.py).
//  2. The list chunks.  The plan also shares S chunk slots out over the
//     channels by their listed rows (s_c = max(1, round(n_c S / total))
//     for a channel with rows), so one channel holding 90% of the rows
//     takes 90% of the slots and every block walks at most about
//     2 total / S rows whatever the mix.  It ranks the slots by the start
//     of their share of the channel, (j / s_c, c): blocks that run
//     together then walk the same stretch of rows in every channel, and
//     the bin sectors one channel's block reads are in L2 for the others'.
//  3. The histogram clusters.  A cluster is the `tiles` blocks (one a bin
//     tile, at most 6 fx / 4 q8) of one (lane, rank, group of fg
//     features); each block keeps bins [b0, b0 + Bt) of its fg features in
//     shared memory, walks 1/tiles of the rank's records and adds each
//     code into the tile that holds it, a peer's through distributed
//     shared memory, so each record and code is read once per feature
//     group, not once per tile.  A warp takes 32 consecutive records a
//     step (no channel scan, no queue), the next ones loading while it
//     gathers their fg codes (eight loads at a time) and adds into shared
//     memory.  A block holds per (feature, bin) 20 bytes fx (int64 g and
//     h, uint32 count) or 12 q8 (int32 g and h, or past one tile one
//     int64 (g << 32) + h; uint32 count); ops/histogram_cuda.py
//     list_geometry sizes fg, Bt and S.  The adds are native, one access
//     width an entry (add_entry): at one tile 32-bit shared reductions
//     (fx's 64-bit weights as two halves with the carry); past one tile
//     one 64-bit DSM reduction for g and h, the block's own tile's too,
//     and a 32-bit count (a DSM add costs several shared ones, so q8's
//     32-bit g, h and count words there took 13-20% longer).  And they
//     merge across the warp (add_codes): the lanes whose code falls on the
//     entry of the warp's first adding lane send one add of their summed
//     weights, so a feature whose codes crowd into one bin costs about one add
//     a warp there, not 32 on one address.  The code gathers set the pace on
//     spread codes: a build that loads every record and code and adds nothing
//     keeps about 90% of the time at B=1024 (a 2-byte code costs a 32-byte
//     sector of the (F, N) matrix), and one that also writes each kept row's
//     codes in list order in the partition, for the histogram to read
//     coalesced, ran slower (scripts/hist_leaves_u16_variants.cu).  Two
//     flushes:
//     * slot mode (q8; fx at one tile, or its raw int64 sums): rank r is
//       the slot table[r] of 2., listed rows [off_c + n_c j / s_c, off_c +
//       n_c (j + 1) / s_c) of channel c; the slots of one channel share
//       its entries, so each block adds its tile into the caller's
//       zero-filled int32 / int64 output with global reductions that
//       return nothing (red.global; the exact lanes form then scales the
//       int64 sums to f32 in one pass, fx_scale_lanes);
//     * owner mode (fx's f32 values past one tile, the plan of S = 0
//       slots: one slot a channel with rows, whatever its share): rank r
//       is channel r and its cluster walks all of the channel's records,
//       so its shared memory ends with the final sums of those fg
//       features; each block writes its tile as f32, (float)((double)sum
//       x scale[k]), bitwise ops/histogram.py fx_to_f32, with plain
//       stores, an empty channel's zeros too.  No int64 histogram, zero
//       fill, global atomic or float64 pass reaches device memory (at
//       B=65,535 and L=4 they came to ~37 GB of traffic and 13.2 GB held
//       a call, by the sizes).  A channel holding most rows makes its
//       clusters the launch's tail, yet on a 90%-skewed mix owner mode
//       still beat slot mode's atomics and scale-back; slot mode stays
//       at one tile, where its int64 output is small.
//  4. The model-axis forms (the reference's vmap of these entry points;
//     multitrain's lanes, each with its own channels and weights over the
//     shared bins): the lane is grid y of the partition's two kernels,
//     each lane with its own plan (offsets, slots, table, counts) and its
//     records at a per-lane base, so the partition's shared tables still
//     hold K <= 64 channels (L lanes x 42 channels would not fit one
//     channel space).  The histograms then run one launch of every
//     lane's clusters, feature-major (a feature group's clusters of every
//     lane and channel together: its bin rows stay in L2 across the
//     lanes; ops/histogram_cuda.py list_lane_order).  A launch a lane and
//     one launch lane-major (a channel's feature groups together) stay
//     as orders the tests and the sweep run.  PERF.md section 6 has the
//     sweeps (scripts/torch_u16_lanes_sweep.py).
//
// The sums are integers, so the result is bit-identical from run to run
// and to the plain versions (ops/histogram_cuda.py *_plain).  q8's int32
// words wrap mod 2^32 as the int32 output does; its (g << 32) + h word
// past one tile holds sum h in the low 32 bits because list_geometry
// keeps every slot under 2^24 rows (list_slots_least): |sum h| <= 128 x
// 2^24 = 2^31.  A warp's merged q8 weights sum in one 32-bit word (g +
// 65536 h: 32 int8 weights stay within 16 bits), fx's 64-bit ones as
// three 32-bit parts.
//
// Times, beside the queue-scan design they replace and one int64
// index_add_ of the same sums: PERF.md section 6 (chip_smoke.py phases
// 15a and 12f; the sweeps, scripts/torch_u16_leaf_sweep.py and
// scripts/torch_u16_lanes_sweep.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;   // 64 registers a thread: one block per SM
constexpr int kMaxK = 64;        // channels the partition takes
constexpr int kBatch = 8;        // bin loads of one listed row issued together
constexpr int kPartThreads = 512;                 // a partition block
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kCountThreads = 256;                // a count block
constexpr int kCountAhead = 4;   // 16-row groups a count thread loads at once
constexpr int kSmallInts = 7 * (kMaxK + 8);       // the scatter's tables
constexpr unsigned int kFull = 0xffffffffu;

// A tile of the scatter: kSlots rows a thread, kRows in all, each staged
// as a kRecBytes record (q8 8 bytes, fx 32) and its 4-byte place.
template <typename W>
struct PartTile {
  static constexpr int kSlots = sizeof(W) == 1 ? 8 : 4;
  static constexpr int kRows = kPartThreads * kSlots;
  static constexpr int kRecBytes = sizeof(W) == 1 ? 8 : 32;
  // records, places, the warps' counters, the small tables, the tile's
  // channels, and (q8) its three weight bytes a row
  static constexpr int kSmem = kRows * (kRecBytes + 4) +
                               kPartWarps * kMaxK * 4 + kSmallInts * 4 +
                               kRows * (sizeof(W) == 1 ? 4 : 1);
};

__device__ __forceinline__ unsigned int lanes_below() {
  unsigned int m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int warp_incl(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Bytes [r, r + 16) of p as one int4, those at or past r1 = fill: one
// 16-byte load where p + r is 16-byte aligned and the group whole.
__device__ __forceinline__ int4 load16(const int8_t* p, long long r,
                                       long long r1, bool aligned,
                                       int8_t fill) {
  if (aligned && r + 16 <= r1)
    return __ldg(reinterpret_cast<const int4*>(p + r));
  union {
    int4 v;
    int8_t b[16];
  } u;
#pragma unroll
  for (int j = 0; j < 16; ++j) u.b[j] = r + j < r1 ? __ldg(p + r + j) : fill;
  return u.v;
}

// Block b's rows [b * block_rows, (b + 1) * block_rows), cut at N;
// block_rows is a multiple of 16, so every 16-row group of an aligned
// pointer starts 16-byte aligned.
__device__ __forceinline__ void block_span(long long N, long long block_rows,
                                           long long* r0, long long* r1) {
  *r0 = (long long)blockIdx.x * block_rows;
  *r1 = min(N, *r0 + block_rows);
}

// The plan of one lane: offsets (K + 1) | slots (K) | table (S + K) |
// counts (K x P).
__host__ __device__ __forceinline__ long long plan_ints(int K, int P, int S) {
  return 3LL * K + 1 + S + (long long)K * P;
}

// counts[c * P + b]: the rows of channel c in block b.  Each thread reads
// 16 rows a load and counts them in counters of its own (shared memory,
// cnt[c][thread]: a lane's bank is its own whatever the channel, and no
// add waits on another lane's, however many rows one channel holds); a
// warp a channel then sums them.  The model-axis form (lanes, grid y =
// lane): lane z's channels from lanes[z], its plan plan_ls ints further
// on.
__global__ void __launch_bounds__(kCountThreads)
part_count(const int8_t* __restrict__ ch, long long N, int K, int S,
           long long block_rows, int* __restrict__ plan,
           const long long* __restrict__ lanes, long long plan_ls) {
  extern __shared__ int cnt[];   // K x kCountThreads
  if (lanes) {
    ch = reinterpret_cast<const int8_t*>(lanes[blockIdx.y]);
    plan += blockIdx.y * plan_ls;
  }
  int* counts = plan + 3 * K + 1 + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < K * kCountThreads; i += kCountThreads)
    cnt[i] = 0;
  __syncthreads();
  long long r0, r1;
  block_span(N, block_rows, &r0, &r1);
  const bool aligned = (reinterpret_cast<uintptr_t>(ch) & 15) == 0;
  int* mine = cnt + threadIdx.x;   // channel c at mine[c * kCountThreads]
  constexpr long long kStep = 16LL * kCountThreads;
  for (long long g = r0 + 16LL * threadIdx.x; g < r1;
       g += kStep * kCountAhead) {
    int4 v[kCountAhead];
#pragma unroll
    for (int a = 0; a < kCountAhead; ++a)
      v[a] = load16(ch, g + kStep * a, r1, aligned, -1);
#pragma unroll
    for (int a = 0; a < kCountAhead; ++a) {
      const int word[4] = {v[a].x, v[a].y, v[a].z, v[a].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = (signed char)(word[j >> 2] >> (8 * (j & 3)));
        if ((unsigned int)c < (unsigned int)K) mine[c * kCountThreads] += 1;
      }
    }
  }
  __syncthreads();
  for (int c = warp; c < K; c += kCountThreads / 32) {
    int sum = 0;
#pragma unroll
    for (int v = lane; v < kCountThreads; v += 32)
      sum += cnt[c * kCountThreads + v];
    sum = warp_sum(sum);
    if (lane == 0) counts[(long long)c * gridDim.x + blockIdx.x] = sum;
  }
}

// The scatter's small tables in shared memory.
struct PartTables {
  int* tot;      // rows of each channel (all blocks)
  int* place;    // this block's next place in each channel
  int* shift;    // a tile's place in the list minus its place in the stage
  int* slot_n;   // slots of each channel
  int* offs;     // each channel's offset, offs[K] the total
  int* tstart;   // each channel's start in the tile's stage, [K] its rows
  int* slot_pre; // the slots of the channels before each, [K] all
};

// tot, offs and this block's place in each channel, from every block's
// counts: offs[c] + the rows of channel c in blocks before this one.
__device__ void block_places(const int* __restrict__ counts, int K, int P,
                             const PartTables& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  for (int c = warp; c < K; c += kPartWarps) {
    int all = 0, before = 0;
#pragma unroll 4
    for (int q = lane; q < P; q += 32) {
      const int v = counts[(long long)c * P + q];
      all += v;
      before += q < b ? v : 0;
    }
    all = warp_sum(all);
    before = warp_sum(before);
    if (lane == 0) {
      t.tot[c] = all;
      t.place[c] = before;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int a = lane < K ? t.tot[lane] : 0;
    const int z = lane + 32 < K ? t.tot[lane + 32] : 0;
    const int ia = warp_incl(a), iz = warp_incl(z);
    const int half = __shfl_sync(kFull, ia, 31);
    if (lane < K) {
      t.offs[lane] = ia - a;
      t.place[lane] += ia - a;
    }
    if (lane + 32 < K) {
      t.offs[lane + 32] = half + iz - z;
      t.place[lane + 32] += half + iz - z;
    }
    if (lane == 31) t.offs[K] = half + iz;
  }
  __syncthreads();
}

// Block 0 of each lane: offsets (K + 1); the slots s_c of each channel
// out of S; table[rank] = (j << 8) | c for slot j of channel c, ranked by
// (j / s_c, c), -1 past the last slot (S + K entries).  One warp a slot:
// its channel is the count of channels whose slots end at or before it,
// and its rank j + the slots of every other channel that start before
// j / s_c (and those that start with it, of a lower channel), a lane
// counting two channels.  The arithmetic of ops/histogram_cuda.py
// list_slots.
__device__ void write_plan(int K, int S, const PartTables& t,
                           int* __restrict__ offsets, int* __restrict__ slots,
                           int* __restrict__ table) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = t.offs[K];
  for (int c = threadIdx.x; c <= K; c += blockDim.x) offsets[c] = t.offs[c];
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    const long long nc = t.tot[c];
    int s = 0;
    if (nc > 0) s = (int)max(1LL, (2 * nc * S + total) / (2LL * total));
    t.slot_n[c] = s;
    slots[c] = s;
  }
  for (int i = threadIdx.x; i < S + K; i += blockDim.x) table[i] = -1;
  __syncthreads();
  if (warp == 0) {
    const int a = lane < K ? t.slot_n[lane] : 0;
    const int z = lane + 32 < K ? t.slot_n[lane + 32] : 0;
    const int ia = warp_incl(a), iz = warp_incl(z);
    const int half = __shfl_sync(kFull, ia, 31);
    if (lane < K) t.slot_pre[lane] = ia - a;
    if (lane + 32 < K) t.slot_pre[lane + 32] = half + iz - z;
    if (lane == 31) t.slot_pre[K] = half + iz;
  }
  __syncthreads();
  const int used = t.slot_pre[K];
  for (int u = warp; u < used; u += kPartWarps) {
    int ended = 0;
    for (int c = lane; c < K; c += 32) ended += t.slot_pre[c + 1] <= u;
    const int c = warp_sum(ended);
    const unsigned int j = u - t.slot_pre[c], sc = t.slot_n[c];
    unsigned int part = 0;
    for (int d = lane; d < K; d += 32) {
      const unsigned int sd = t.slot_n[d];
      if (d == c || sd == 0) continue;
      const unsigned int q = j * sd;
      part += (q + sc - 1) / sc + (d < c && q % sc == 0);
    }
    const unsigned int rank = j + (unsigned int)warp_sum((int)part);
    if (lane == 0) table[rank] = (int)((j << 8) | c);
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

// Block b's rows in row order to their records, tile by tile.  The block
// first finds its place in every channel from the counts (block_places;
// block 0 also writes the plan).  Then, per tile of kRows rows (a warp
// owns kSlots x 32 consecutive rows of it, slot i its rows i x 32 +
// lane): the tile's channels (and q8 weights) arrive in shared memory in
// 16-byte loads issued one tile ahead; each warp ranks its rows within
// their channel (__match_any_sync over a step's lanes, one shared atomic
// per channel a step for the warp's running count); warp 0 turns the warps'
// counts into each warp's start in each channel of the tile and the
// tile's channel starts; every kept row's record goes to the stage,
// channel-sorted, beside its place in the list; and the block writes the
// stage out in order, consecutive threads on consecutive records, so a
// channel's run leaves in whole lines.  The model-axis form (lanes,
// grid y = lane): lane z's channels and weights from lanes[z] and
// lanes[L + z], its plan plan_ls ints and its records rec_ls int64
// further on.
template <typename W>
__global__ void __launch_bounds__(kPartThreads, 2)
part_scatter(const int8_t* __restrict__ ch, const W* __restrict__ w,
             long long N, int K, int S, long long block_rows,
             int* __restrict__ plan, long long* __restrict__ rec,
             const long long* __restrict__ lanes, int L, long long plan_ls,
             long long rec_ls) {
  constexpr bool Q8 = sizeof(W) == 1;
  constexpr int R = PartTile<W>::kSlots, TR = PartTile<W>::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {
    const int z = blockIdx.y;
    ch = reinterpret_cast<const int8_t*>(lanes[z]);
    w = reinterpret_cast<const W*>(lanes[L + z]);
    plan += z * plan_ls;
    rec += z * rec_ls;
  }
  long long* stage = reinterpret_cast<long long*>(smem);
  int* sdst = reinterpret_cast<int*>(smem + TR * PartTile<W>::kRecBytes);
  int* wcnt = sdst + TR;                    // [warp][channel]
  int* small = wcnt + kPartWarps * kMaxK;
  const PartTables t{small, small + (kMaxK + 8), small + 2 * (kMaxK + 8),
                     small + 3 * (kMaxK + 8), small + 4 * (kMaxK + 8),
                     small + 5 * (kMaxK + 8), small + 6 * (kMaxK + 8)};
  int8_t* ch_s = reinterpret_cast<int8_t*>(small + kSmallInts);
  int8_t* w_s = ch_s + TR;                  // q8: 3 rows of TR bytes
  int* offsets = plan;
  int* slots = offsets + K + 1;
  int* table = slots + K;
  const int* counts = table + S + K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  block_places(counts, K, gridDim.x, t);
  if (blockIdx.x == 0) write_plan(K, S, t, offsets, slots, table);

  long long r0, r1;
  block_span(N, block_rows, &r0, &r1);
  const int8_t* w8 = reinterpret_cast<const int8_t*>(w);
  const bool loader = threadIdx.x < TR / 16;
  const bool ch_aligned = (reinterpret_cast<uintptr_t>(ch) & 15) == 0;
  const bool w_aligned =
      ((reinterpret_cast<uintptr_t>(w) | (uintptr_t)N) & 15) == 0;
  int4 nch = {0, 0, 0, 0}, nw[3] = {nch, nch, nch};   // the next tile's
  auto fetch = [&](long long t0) {
    const long long r = t0 + 16LL * threadIdx.x;
    nch = load16(ch, r, r1, ch_aligned, -1);
    if constexpr (Q8) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        nw[q] = load16(w8 + q * N, r, r1, w_aligned, 0);
    }
  };
  if (loader && r0 < r1) fetch(r0);
  const unsigned int below = lanes_below();
  const int xb = warp * 32 * R + lane;      // this lane's row of slot 0

  for (long long t0 = r0; t0 < r1; t0 += TR) {
    if (loader) {
      reinterpret_cast<int4*>(ch_s)[threadIdx.x] = nch;
      if constexpr (Q8) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          reinterpret_cast<int4*>(w_s + q * TR)[threadIdx.x] = nw[q];
      }
    }
    for (int c = lane; c < kMaxK; c += 32) wcnt[warp * kMaxK + c] = 0;
    __syncthreads();   // the tile's channels are in; the counters zeroed
    if (loader && t0 + TR < r1) fetch(t0 + TR);

    int key[R], rank[R];
    W wv[R][3];        // fx: the kept rows' weights, loaded while ranking
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = ch_s[xb + i * 32];
      key[i] = (c >= 0 && c < K) ? c : -1;
    }
    if constexpr (!Q8) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long r = t0 + xb + i * 32;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          wv[i][q] = key[i] >= 0 ? __ldg(w + q * N + r) : W(0);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // rank among the warp's rows of the channel so far: the lowest lane
      // of the step's peers (the kept lanes of its channel) adds them all
      // to the warp's count and hands the count before them to its peers
      // (nothing when no lane keeps a row).  __match_any_sync took 3-27%
      // less scatter time than one ballot per key bit (PERF.md)
      const unsigned int kept = __ballot_sync(kFull, key[i] >= 0);
      rank[i] = 0;
      if (kept == 0) continue;
      const unsigned int peers = __match_any_sync(kFull, key[i]) & kept;
      const int lead = peers ? __ffs(peers) - 1 : lane;
      int old = 0;
      if (key[i] >= 0 && lane == lead)
        old = atomicAdd(&wcnt[warp * kMaxK + key[i]], __popc(peers));
      rank[i] = __shfl_sync(kFull, old, lead) + __popc(peers & below);
    }
    __syncthreads();   // every warp's count of every channel

    if (warp == 0) {
      // each warp's start in each channel of the tile, the tile's
      // channel starts in the stage, and the block's places after it
      int n2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        int run = 0;
        if (c < K) {
          for (int v = 0; v < kPartWarps; ++v) {
            const int x = wcnt[v * kMaxK + c];
            wcnt[v * kMaxK + c] = run;
            run += x;
          }
        }
        n2[h] = run;
      }
      const int ia = warp_incl(n2[0]), iz = warp_incl(n2[1]);
      const int half = __shfl_sync(kFull, ia, 31);
      const int st[2] = {ia - n2[0], half + iz - n2[1]};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (c < K) {
          t.tstart[c] = st[h];
          t.shift[c] = t.place[c] - st[h];
          t.place[c] += n2[h];
        }
      }
      if (lane == 31) t.tstart[K] = half + iz;
    }
    __syncthreads();   // the tile's starts

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = key[i];
      if (c < 0) continue;
      const int x = xb + i * 32;
      const int pos = t.tstart[c] + wcnt[warp * kMaxK + c] + rank[i];
      const long long row = t0 + x;
      if constexpr (Q8) {
        stage[pos] = row | ((long long)(unsigned char)w_s[x] << 32) |
                     ((long long)(unsigned char)w_s[TR + x] << 40) |
                     ((long long)(unsigned char)w_s[2 * TR + x] << 48);
      } else {
        longlong2* q = reinterpret_cast<longlong2*>(stage) + 2 * pos;
        q[0] = make_longlong2(wv[i][0], wv[i][1]);
        q[1] = make_longlong2(row | (wv[i][2] << 32), 0LL);
      }
      sdst[pos] = pos + t.shift[c];
    }
    __syncthreads();   // the stage is whole

    const int kept = t.tstart[K];
    if constexpr (Q8) {
      for (int i = threadIdx.x; i < kept; i += kPartThreads)
        rec[sdst[i]] = stage[i];
    } else {
      // a 16-byte half of a record a thread
      const longlong2* s2 = reinterpret_cast<const longlong2*>(stage);
      longlong2* r2 = reinterpret_cast<longlong2*>(rec);
      for (int i = threadIdx.x; i < 2 * kept; i += kPartThreads)
        r2[2LL * sdst[i >> 1] + (i & 1)] = s2[i];
    }
  }
}

// The histogram's arguments, one struct a launch (the lanes' bases and
// strides: lane z's records, plan and output rec_ls, plan_ls and out_ls
// after lane z - 1's).
struct ListArgs {
  const uint16_t* bins;   // (F, N) feature-major codes
  const long long* rec;
  const int* plan;
  void* out;
  const double* scale;    // owner mode: (L, 3) float64
  long long N, rec_ls, plan_ls, out_ls;
  int F, B, K, S, fg, Bt, tiles, f_groups, L;
  bool feature_major;
};

// A cluster of the histogram: `tiles` consecutive blocks, one a bin tile,
// for one (lane, rank, feature group).  Lane-major (a launch a lane, or
// one launch with the lane outermost): cluster ((lane x ranks + rank) x
// f_groups + g), so the feature groups of one rank (one channel's slot)
// run together.  Feature-major: cluster ((g x L + lane) x ranks + rank),
// so every lane's and channel's clusters of one feature group run
// together.
struct ClusterOf {
  int lane, rank, g, tile;
};

__device__ __forceinline__ ClusterOf cluster_of(int tiles, int f_groups,
                                               int ranks, int L,
                                               bool feature_major) {
  ClusterOf o;
  unsigned int u = blockIdx.x / tiles;
  o.tile = blockIdx.x % tiles;   // == cluster.block_rank()
  if (feature_major) {
    o.rank = u % ranks;
    u /= ranks;
    o.lane = u % L;
    o.g = u / L;
  } else {
    o.g = u % f_groups;
    u /= f_groups;
    o.rank = u % ranks;
    o.lane = u / ranks;
  }
  return o;
}

// Shared-window addresses are 32 bits.  The native 32-bit shared adds:
// with the old value back (ATOMS.ADD) and with none; a peer's shared
// memory in the cluster (mapa) and the no-return reductions into it; and
// the no-return reductions into device memory (the result).
__device__ __forceinline__ unsigned int sh(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned int atom_sh(unsigned int a,
                                                unsigned int v) {
  unsigned int old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(a), "r"(v));
  return old;
}

__device__ __forceinline__ void red_sh(unsigned int a, unsigned int v) {
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a), "r"(v));
}

__device__ __forceinline__ unsigned int dsm(unsigned int a, int rank) {
  unsigned int m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(m)
               : "r"(a), "r"(rank));
  return m;
}

__device__ __forceinline__ void red_dsm(unsigned int a, unsigned int v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ void red_dsm(unsigned int a,
                                        unsigned long long v) {
  asm volatile("red.shared::cluster.add.u64 [%0], %1;" ::"r"(a), "l"(v)
               : "memory");
}

__device__ __forceinline__ void red_global(int* p, int v) {
  asm volatile("red.global.add.u32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ void red_global(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "l"(v)
               : "memory");
}

// What a row's visitor sees of its block: its lane, its features f0 ..
// f0 + nf and the codes of feature f0 (the others N apart), the bins, the
// block's tile of Bt bins, and its shared histogram of E = fg x Bt
// entries at shared address `base`: q8 int32 g[E] | int32 h[E] (past one
// tile int64 (g << 32) + h [E]) | uint32 count[E], fx int64 g[E] | int64
// h[E] | uint32 count[E]; entry (k, b) = k x Bt + b - b0 in the tile of
// b.
struct ListBlock {
  const uint16_t* col0;
  long long N;
  int lane, f0, nf, B, Bt, tile, E;
  unsigned int base;
};

// One cluster (ClusterOf) of `tiles` blocks (CL: tiles > 1, launched as
// thread-block clusters): each keeps its bin tile's histogram in shared
// memory, walks 1/tiles of the rank's records, and hands them to `row` a
// warp at a time (each lane's record, its place in the lane's list, and
// whether it is live: in the slot, with a weight), which adds the live
// records' codes into the tile that holds each, its own or a peer's
// through distributed shared memory.  So every record and code is read
// once per feature group, whatever the tiles.
//   Slot mode (Owner false): rank r is the plan's slot table[r] (-1: no
// slot), its share of the channel's records; the flush adds the tile into
// out, int32 (q8) or int64 (fx) zero-filled by the caller, with global
// reductions, as the slots of one channel share its entries.
//   Owner mode (fx, Owner true; the plan of S = 0 slots): rank r is
// channel r, and the cluster walks all of its records, so its shared
// memory ends with the channel's final sums; the flush writes them as f32,
// (float)((double)sum x scale[k]) for lane z's (3,) float64 scale (bitwise
// ops/histogram.py fx_to_f32), with plain stores.  Every entry is written
// once, an empty channel's zeros too: no zero fill, no atomics.
template <typename W, bool Owner, bool CL, typename Row>
__device__ __forceinline__ void list_block(const ListArgs& a, Row& row) {
  constexpr bool Q8 = sizeof(W) == 1;
  static_assert(!(Q8 && Owner), "owner mode writes the fx form's f32");
  extern __shared__ __align__(16) unsigned char smem[];
  // the same (lane, rank, group) for the whole cluster: it returns or
  // syncs together
  const ClusterOf at =
      cluster_of(a.tiles, a.f_groups, a.S + a.K, a.L, a.feature_major);
  const long long* rec = a.rec + at.lane * a.rec_ls;
  const int* offsets = a.plan + at.lane * a.plan_ls;
  const int* slots = offsets + a.K + 1;
  const int* table = slots + a.K;
  int c = at.rank, j = 0;
  long long sc = 1;
  if constexpr (!Owner) {
    const int slot = table[at.rank];
    if (slot < 0) return;   // a rank no channel took
    c = slot & 255;
    j = slot >> 8;
    sc = slots[c];
  }
  const int tile = at.tile, Bt = a.Bt, tiles = a.tiles;
  const int b0 = tile * Bt;
  const int f0 = at.g * a.fg;
  const int nf = min(a.fg, a.F - f0);
  const int nbt = min(Bt, a.B - b0);
  const long long oc = offsets[c], nc = offsets[c + 1] - oc;
  const long long s0 = oc + nc * j / sc, s1 = oc + nc * (j + 1) / sc;
  const long long p0 = s0 + (s1 - s0) * tile / tiles;
  const long long p1 = s0 + (s1 - s0) * (tile + 1) / tiles;
  const int E = a.fg * Bt;
  constexpr int WB = Q8 ? 4 : 8;   // bytes of a g or h word
  int* g32 = reinterpret_cast<int*>(smem);
  long long* g64 = reinterpret_cast<long long*>(smem);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(smem + 2 * WB * E);
  for (int i = threadIdx.x; i < 2 * E; i += blockDim.x) {
    if constexpr (Q8) g32[i] = 0;
    else g64[i] = 0LL;
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) cnt[i] = 0u;
  if constexpr (CL) cg::this_cluster().sync();   // every peer's zeroed
  else __syncthreads();

  const ListBlock blk{a.bins + (long long)f0 * a.N, a.N, at.lane, f0, nf,
                      a.B, Bt, tile, E, sh(smem)};
  // each thread takes every blockDim-th record, the next one loading
  // while this one's codes load and add.  A warp walks its 32 records a
  // step together (a lane past the end, or whose record has no weight, is
  // not live), so that its adds can merge across the whole warp.
  const int lane = threadIdx.x & 31;
  long long q = p0 + (threadIdx.x - lane);
  Entry nx{0, 0, 0, 0u};
  if (q + lane < p1) nx = load_record<W>(rec, q + lane);
  for (; q < p1; q += blockDim.x) {
    const long long p = q + lane;
    const Entry e = nx;
    if (p + blockDim.x < p1) nx = load_record<W>(rec, p + blockDim.x);
    const bool live = p < p1 && ((e.g | e.h) != 0 || e.n != 0u);
    if (__any_sync(kFull, live)) row(e, p, live, blk);
  }
  if constexpr (CL) cg::this_cluster().sync();   // every peer's adds landed
  else __syncthreads();

  // flush: entry (k, b) -> out[(c * F + f0 + k) * B + b0 + b], consecutive
  // threads on consecutive bins
  const long long base = at.lane * a.out_ls;
  double s[3] = {0.0, 0.0, 0.0};
  if constexpr (Owner) {
    const double* sl = a.scale + 3 * at.lane;
    s[0] = sl[0];
    s[1] = sl[1];
    s[2] = sl[2];
  }
  for (int i = threadIdx.x; i < nf * nbt; i += blockDim.x) {
    const int b = i % nbt;
    const int k = i / nbt;
    const int x = k * Bt + b;
    const long long o =
        base + (((long long)c * a.F + f0 + k) * a.B + b0 + b) * 3;
    const unsigned int n = cnt[x];
    if constexpr (Owner) {
      float* o32 = static_cast<float*>(a.out) + o;
      o32[0] = (float)((double)g64[x] * s[0]);
      o32[1] = (float)((double)g64[E + x] * s[1]);
      o32[2] = (float)((double)n * s[2]);
    } else if constexpr (Q8) {
      int gs = g32[x], hs = g32[E + x];
      if constexpr (CL) {   // (g << 32) + h, mod 2^64
        const unsigned long long w = (unsigned long long)g64[x];
        hs = (int)(unsigned int)w;
        gs = (int)(unsigned int)((w - (unsigned long long)(long long)hs) >>
                                 32);
      }
      int* o32 = static_cast<int*>(a.out) + o;
      if (gs) red_global(o32, gs);
      if (hs) red_global(o32 + 1, hs);
      if (n) red_global(o32 + 2, (int)n);
    } else {
      unsigned long long* o64 = static_cast<unsigned long long*>(a.out) + o;
      if (g64[x]) red_global(o64, (unsigned long long)g64[x]);
      if (g64[E + x]) red_global(o64 + 1, (unsigned long long)g64[E + x]);
      if (n) red_global(o64 + 2, (unsigned long long)n);
    }
  }
}

// One entry's add of (g, h, n): entry x of the tile t that holds its
// code.  Every add is one native access of one width an entry:
//   * q8 at one tile: int32 g, h and count words, red.shared.add.u32 (the
//     int8 weights sign-extended: two's complement adds wrap mod 2^32 as
//     the int32 output does);
//   * q8 past one tile: a DSM reduction costs what several shared adds
//     do, so g and h go as one 64-bit word (g << 32) + h, one
//     red.shared::cluster.add.u64, the block's own too (one access width
//     an entry), and the count as a 32-bit add: two remote adds a code,
//     not three.  With at most 2^24 rows a slot (list_slots_least),
//     |sum h| <= 2^31, so the low word holds sum h and the flush takes
//     sum g from the rest;
//   * fx at one tile: each int64 weight as two 32-bit halves, the low
//     halves with their old values back (atom.shared.add.u32), then the
//     high halves with the carries, exact mod 2^64;
//   * fx past one tile: PTX makes two atomics atomic to each other only
//     where they cover the same bytes, so the halves must not meet a
//     peer's 64-bit reduction on one entry: every g and h add, the
//     block's own too, is one red.shared::cluster.add.u64 (mapa of the
//     owner's rank); the count stays a 32-bit add.
// sm_90a has no native 64-bit shared atomicAdd: on the block's own
// window it is a compare-and-swap loop (ATOMS.CAST.SPIN.64).  So is the
// fallback that ptxas puts behind a 64-bit DSM reduction (a generic
// ATOM.E.ADD.64, native on a peer's window), which the forms past one
// tile keep for their own tile's entries.
template <typename W, bool CL>
__device__ __forceinline__ void add_entry(const ListBlock& b, int x, int t,
                                          long long g, long long h,
                                          unsigned int n) {
  const unsigned int E = (unsigned int)b.E;
  if constexpr (sizeof(W) == 1 && !CL) {
    const unsigned int ga = b.base + 4u * x;
    const unsigned int ha = ga + 4u * E, na = ha + 4u * E;
    if (g) red_sh(ga, (unsigned int)g);
    if (h) red_sh(ha, (unsigned int)h);
    if (n) red_sh(na, n);
  } else if constexpr (sizeof(W) == 1) {
    const unsigned int ga = b.base + 8u * x;
    const unsigned int na = b.base + 8u * E + 4u * x;
    const unsigned long long gh =
        (unsigned long long)g * 0x100000000ULL + (unsigned long long)h;
    if (gh) red_dsm(dsm(ga, t), gh);
    if (n) {
      if (t == b.tile) red_sh(na, n);
      else red_dsm(dsm(na, t), n);
    }
  } else if constexpr (!CL) {
    const unsigned int ga = b.base + 8u * x, ha = ga + 8u * E;
    const unsigned int glo = (unsigned int)g, hlo = (unsigned int)h;
    const unsigned int og = glo ? atom_sh(ga, glo) : 0u;
    const unsigned int oh = hlo ? atom_sh(ha, hlo) : 0u;
    const unsigned int ug = (unsigned int)((unsigned long long)g >> 32) +
                            (og + glo < og ? 1u : 0u);
    const unsigned int uh = (unsigned int)((unsigned long long)h >> 32) +
                            (oh + hlo < oh ? 1u : 0u);
    if (ug) red_sh(ga + 4u, ug);
    if (uh) red_sh(ha + 4u, uh);
    if (n) red_sh(b.base + 16u * E + 4u * x, n);
  } else {
    const unsigned int ga = b.base + 8u * x;
    const unsigned int na = b.base + 16u * E + 4u * x;
    if (g) red_dsm(dsm(ga, t), (unsigned long long)g);
    if (h) red_dsm(dsm(ga + 8u * E, t), (unsigned long long)h);
    if (n) {
      if (t == b.tile) red_sh(na, n);
      else red_dsm(dsm(na, t), n);
    }
  }
}

// The sum over the lanes of `mine` of a 64-bit value, mod 2^64: its low,
// middle 16 bits and high 32 bits summed apart (32 lanes' 16-bit parts
// stay below 2^21), every lane of the warp calling.
__device__ __forceinline__ long long warp_sum64(long long v, bool mine) {
  const unsigned long long u = mine ? (unsigned long long)v : 0ULL;
  const unsigned int lo =
      __reduce_add_sync(kFull, (unsigned int)u & 0xffffu);
  const unsigned int mid =
      __reduce_add_sync(kFull, (unsigned int)(u >> 16) & 0xffffu);
  const unsigned int hi = __reduce_add_sync(kFull, (unsigned int)(u >> 32));
  return (long long)(((unsigned long long)hi << 32) +
                     ((unsigned long long)mid << 16) + lo);
}

// One warp's codes v[0 .. kBatch) of features k .. k + kBatch of its
// block (every lane calls; a lane's code is B or more where it adds
// nothing: outside the histogram, as in plain, or a lane not live), each
// added into entry x of the tile t that holds it (add_entry).  Warp
// merging: the lanes whose code falls on the same entry as the first
// adding lane's send one add of their summed weights (on a feature whose
// codes crowd into one bin most of a warp's do), the others their own.
template <typename W, bool CL>
__device__ __forceinline__ void add_codes(const int* v, int k,
                                          const Entry& e,
                                          const ListBlock& b) {
  const unsigned int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const bool in = v[i] < b.B;
    const unsigned int ins = __ballot_sync(kFull, in);
    if (ins == 0u) continue;
    const int t = CL ? v[i] / b.Bt : 0;
    const int x = (k + i) * b.Bt + v[i] - t * b.Bt;
    const int key = t * b.E + x;
    const int lead = __ffs(ins) - 1;
    const int first = __shfl_sync(kFull, key, lead);   // every lane calls
    const bool mine = in && key == first;
    const unsigned int grp = __ballot_sync(kFull, mine);
    if (__popc(grp) > 1) {
      long long g, h;
      if constexpr (sizeof(W) == 1) {
        // 32 int8 weights sum within 16 bits: g and h in one word
        const int s = __reduce_add_sync(
            kFull, mine ? (unsigned int)(e.g + e.h * 65536) : 0u);
        g = (int)((unsigned int)s << 16) >> 16;
        h = (s - g) >> 16;
      } else {
        g = warp_sum64(e.g, mine);
        h = warp_sum64(e.h, mine);
      }
      const unsigned int n = __reduce_add_sync(kFull, mine ? e.n : 0u);
      if (lane == (unsigned int)lead) add_entry<W, CL>(b, x, t, g, h, n);
      else if (in && !mine) add_entry<W, CL>(b, x, t, e.g, e.h, e.n);
    } else if (in) {
      add_entry<W, CL>(b, x, t, e.g, e.h, e.n);
    }
  }
}

// The package's row: each live lane's codes gathered from the (F, N)
// matrix kBatch at a time (all loads issued before the adds), then
// add_codes.
template <typename W, bool CL>
struct AddCodes {
  __device__ __forceinline__ void operator()(const Entry& e, long long,
                                             bool live, const ListBlock& b) {
    for (int k = 0; k < b.nf; k += kBatch) {
      int v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        v[i] = live && k + i < b.nf
                   ? (int)__ldg(b.col0 + (k + i) * b.N + e.row)
                   : b.B;
      add_codes<W, CL>(v, k, e, b);
    }
  }
};

template <typename W, bool Owner, bool CL>
__global__ void __launch_bounds__(kThreads) hist_list_kernel(ListArgs a) {
  AddCodes<W, CL> row;
  list_block<W, Owner, CL>(a, row);
}

// The slot mode's scale-back (the fx lanes form at one bin tile): lane
// z = grid y's int64 sums h[z x triples ...] of (g, h, count) triples to
// f32, (float)((double)sum x scale[z][k]), bitwise ops/histogram.py
// fx_to_f32 in one pass (8 bytes read, 4 written an entry) where torch
// takes three (to float64, multiply, to float32).
__global__ void __launch_bounds__(256)
fx_scale_kernel(const long long* __restrict__ h,
                const double* __restrict__ scale, float* __restrict__ out,
                long long triples) {
  const double* sl = scale + 3 * blockIdx.y;
  const double s0 = sl[0], s1 = sl[1], s2 = sl[2];
  const long long base = 3LL * triples * blockIdx.y;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < triples; t += (long long)gridDim.x * blockDim.x) {
    const long long i = base + 3 * t;
    const long long a = __ldg(h + i), b = __ldg(h + i + 1),
                    n = __ldg(h + i + 2);
    out[i] = (float)((double)a * s0);
    out[i + 1] = (float)((double)b * s1);
    out[i + 2] = (float)((double)n * s2);
  }
}

// Dynamic shared memory past 48 KB, and the whole L1 carveout as shared
// memory, so that LIST_PART_SM_BLOCKS scatter blocks fit an SM.
template <typename Kern>
int prepare(Kern kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// Rows of each partition block: ceil(N / P), rounded up to 16 rows.
long long part_block_rows(long long N, int P) {
  return ((N + P - 1) / P + 15) / 16 * 16;
}

// lanes: null for one lane, else the device table (2, L) of each lane's
// ch and w pointers; lane z's records and plan lie z x N records and z x
// plan_ints(K, P, S) ints after the first.  Two launches: the count, then
// the scatter (whose block 0 writes the plan).
template <typename W>
int partition(const void* ch, const void* w, long long N, int K, int P,
              int S, void* rec, void* plan, void* stream,
              const long long* lanes = nullptr, int L = 1) {
  if (N <= 0 || K <= 0 || L <= 0) return 0;
  if (K > kMaxK || P <= 0 || S < 0 || N > 0x7fffffffLL || L > 65535 ||
      (long long)K * P * sizeof(int) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plan_ls = lanes ? plan_ints(K, P, S) : 0;
  const long long rec_ls = lanes ? N * (sizeof(W) == 1 ? 1 : 4) : 0;
  const long long block_rows = part_block_rows(N, P);
  const int smem = PartTile<W>::kSmem;
  const int count_smem = K * kCountThreads * (int)sizeof(int);
  int err = prepare(part_scatter<W>, smem);
  if (err == 0) err = prepare(part_count, count_smem);
  if (err != 0) return err;
  const int8_t* c8 = static_cast<const int8_t*>(ch);
  int* p = static_cast<int*>(plan);
  const dim3 grid(P, L);
  part_count<<<grid, kCountThreads, count_smem, s>>>(c8, N, K, S, block_rows,
                                                     p, lanes, plan_ls);
  part_scatter<W><<<grid, kPartThreads, smem, s>>>(
      c8, static_cast<const W*>(w), N, K, S, block_rows, p,
      static_cast<long long*>(rec), lanes, L, plan_ls, rec_ls);
  return (int)cudaGetLastError();
}

// The histogram launches over L lanes' partitions (lane z's records,
// plan and (K, F, B, 3) output rec_ls, plan_ls and out_ls after lane z -
// 1's): order kLaunchPerLane one launch a lane, kLaneMajor and
// kFeatureMajor one launch of every lane's clusters (ClusterOf).  scale:
// null for slot mode, else owner mode's (L, 3) float64 scales (S must be
// 0).  one_tile and clustered: the kernels at one bin tile and past it
// (a thread-block cluster of `tiles` blocks).
constexpr int kLaunchPerLane = 0;
constexpr int kLaneMajor = 1;
constexpr int kFeatureMajor = 2;

using ListKernel = void (*)(ListArgs);

template <typename W>
int hist_launch(ListKernel kernel, const ListArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.fg * a.Bt * (sizeof(W) == 1 ? 12 : 20);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)a.L * a.f_groups * a.tiles * (a.S + a.K);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.tiles;   // a cluster: the tiles of a column
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W, bool Owner>
int hist_lanes(const void* bins, const void* rec, const void* plan,
               void* out, const void* scale, int L, int F, long long N,
               int B, int K, int fg, int Bt, int S, int P, int order,
               void* stream,
               ListKernel one_tile = hist_list_kernel<W, Owner, false>,
               ListKernel clustered = hist_list_kernel<W, Owner, true>) {
  if (L <= 0 || F <= 0 || K <= 0) return 0;
  if (N <= 0 && !Owner) return 0;   // owner mode still writes the zeros
  if (fg <= 0 || Bt <= 0 || Bt > B || S < 0 || (S == 0) != Owner ||
      order < kLaunchPerLane || order > kFeatureMajor)
    return (int)cudaErrorInvalidValue;
  ListArgs a;
  a.tiles = (B + Bt - 1) / Bt;
  if (a.tiles > 8) return (int)cudaErrorInvalidValue;
  a.bins = static_cast<const uint16_t*>(bins);
  a.rec = static_cast<const long long*>(rec);
  a.plan = static_cast<const int*>(plan);
  a.out = out;
  a.scale = static_cast<const double*>(scale);
  a.N = N;
  a.rec_ls = N * (sizeof(W) == 1 ? 1 : 4);
  a.plan_ls = plan_ints(K, P, S);
  a.out_ls = (long long)K * F * B * 3;
  a.F = F;
  a.B = B;
  a.K = K;
  a.S = S;
  a.fg = fg;
  a.Bt = Bt;
  a.f_groups = (F + fg - 1) / fg;
  a.L = L;
  a.feature_major = order == kFeatureMajor;
  const ListKernel kernel = a.tiles > 1 ? clustered : one_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order != kLaunchPerLane) return hist_launch<W>(kernel, a, s);
  // a launch a lane: lane z's bases, one lane each
  const int out_bytes = Owner ? 4 : sizeof(W) == 1 ? 4 : 8;
  ListArgs one = a;
  one.L = 1;
  one.rec_ls = one.plan_ls = one.out_ls = 0;
  for (int z = 0; z < L; ++z) {
    one.rec = a.rec + z * a.rec_ls;
    one.plan = a.plan + z * a.plan_ls;
    one.out = static_cast<char*>(out) + z * a.out_ls * out_bytes;
    one.scale = Owner ? a.scale + 3 * z : nullptr;
    const int err = hist_launch<W>(kernel, one, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// The channel partition: ch (N,) int8; w (3, N) weight rows (wbytes 8:
// int64 fx, 1: int8 q8, the first three rows of the (8, N) wch); rec the
// records, (N, 4) int64 (fx) or (N,) int64 (q8), the first offsets[K]
// written; plan int32 (K + 1) + K + (S + K) + K P, written whole.  P
// row blocks, S chunk slots.  N < 2^31, K <= 64.
int leaf_partition(const void* ch, const void* w, int wbytes, long long N,
                   int K, int P, int S, void* rec, void* plan, void* stream) {
  return wbytes == 1
             ? partition<int8_t>(ch, w, N, K, P, S, rec, plan, stream)
             : partition<long long>(ch, w, N, K, P, S, rec, plan, stream);
}

// The histograms over the partition's records: bins (F, N) uint16; rec
// and plan from leaf_partition; fg features and Bt bins per block; S the
// partition's slots.  q8: out (K, F, B, 3) int32, zero-filled by the
// caller.  fx: scale null, out (K, F, B, 3) int64 zero-filled by the
// caller (slot mode); else scale the (3,) float64 scale of the f32 values
// and out (K, F, B, 3) float32, written whole (owner mode: S = 0).
int hist_leaves_fx_u16(const void* bins, const void* rec, const void* plan,
                       void* out, const void* scale, int F, long long N,
                       int B, int K, int fg, int Bt, int S, void* stream) {
  return scale ? hist_lanes<long long, true>(bins, rec, plan, out, scale, 1,
                                             F, N, B, K, fg, Bt, S, 0,
                                             kLaneMajor, stream)
               : hist_lanes<long long, false>(bins, rec, plan, out, nullptr,
                                              1, F, N, B, K, fg, Bt, S, 0,
                                              kLaneMajor, stream);
}

int hist_leaves_q8_u16(const void* bins, const void* rec, const void* plan,
                       void* out, int F, long long N, int B, int K, int fg,
                       int Bt, int S, void* stream) {
  return hist_lanes<int8_t, false>(bins, rec, plan, out, nullptr, 1, F, N, B,
                                   K, fg, Bt, S, 0, kLaneMajor, stream);
}

// The model-axis forms (the reference's vmap of its uint16 leaf
// histograms): L lanes' channels and weights over the shared bins.  The
// partition, lane z as grid y of its two kernels: lanes the device
// table (2, L) [ch pointer, w pointer] of each lane (w as in
// leaf_partition); rec (L, N, 4) or (L, N) int64; plan L x (3 K + 1 + S +
// K P) int32, each lane's laid out as leaf_partition's.  Lane z's list
// is its single partition's, record for record.
int leaf_partition_lanes(const void* lanes, int wbytes, long long N, int K,
                         int P, int S, void* rec, void* plan, int L,
                         void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  return wbytes == 1
             ? partition<int8_t>(nullptr, nullptr, N, K, P, S, rec, plan,
                                 stream, t, L)
             : partition<long long>(nullptr, nullptr, N, K, P, S, rec, plan,
                                    stream, t, L);
}

// The histograms over leaf_partition_lanes' records and plans, lane z's
// (K, F, B, 3) output K x F x B x 3 entries after lane z - 1's.  fx:
// scale null, out int64 zero-filled by the caller (slot mode); else scale
// each lane's (3,) float64 scale, (L, 3), and out float32 written whole
// (owner mode: S = 0).  q8: out int32 zero-filled by the caller.  order:
// 0 a launch a lane, 1 one launch lane-major, 2 one launch feature-major
// (see the head of this file).
int hist_leaves_fx_lanes_u16(const void* bins, const void* rec,
                             const void* plan, void* out, const void* scale,
                             int L, int F, long long N, int B, int K, int fg,
                             int Bt, int S, int P, int order, void* stream) {
  return scale ? hist_lanes<long long, true>(bins, rec, plan, out, scale, L,
                                             F, N, B, K, fg, Bt, S, P, order,
                                             stream)
               : hist_lanes<long long, false>(bins, rec, plan, out, nullptr,
                                              L, F, N, B, K, fg, Bt, S, P,
                                              order, stream);
}

int hist_leaves_q8_lanes_u16(const void* bins, const void* rec,
                             const void* plan, void* out, int L, int F,
                             long long N, int B, int K, int fg, int Bt, int S,
                             int P, int order, void* stream) {
  return hist_lanes<int8_t, false>(bins, rec, plan, out, nullptr, L, F, N, B,
                                   K, fg, Bt, S, P, order, stream);
}

// The slot mode's scale-back: h (L, triples, 3) int64 sums, scale (L, 3)
// float64, out (L, triples, 3) float32.
int fx_scale_lanes(const void* h, const void* scale, void* out,
                   long long triples, int L, void* stream) {
  if (triples <= 0 || L <= 0) return 0;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  const long long want = (triples + 255) / 256;
  const dim3 grid((unsigned int)(want < 4096 ? want : 4096), L);
  fx_scale_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(h), static_cast<const double*>(scale),
      static_cast<float*>(out), triples);
  return (int)cudaGetLastError();
}

}  // extern "C"

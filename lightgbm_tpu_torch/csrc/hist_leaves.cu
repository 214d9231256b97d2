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
//   * q8: int8 weights -> int32 sums (as the reference, exact: 32-bit
//     adds wrap as the plain version's int64 sums cast to int32);
//   * fx: the wrapper converts g*mask and h*mask to 64-bit fixed point with
//     a per-tree power-of-two scale (ops/histogram.py pack_weights), the
//     kernel sums int64, the wrapper scales back to f32 (the lanes form in
//     one pass, hist_leaves_u16.cu fx_scale_lanes).  The count row is
//     pack_weights' 0/1 membership, summed in 32 bits per block.
//
// The bound on the H100: bytes.  chip_smoke.py counts each input byte once:
// the channel byte of every row, the F bin bytes and the weights (24 B fx,
// 3 B q8) of every row in a channel, and the (K, F, B, 3) output; at the
// main shape (F=28, N=10,502,144, B=256, half the rows in a channel) about
// 0.17-0.18 GB, 0.05 ms at 3.35 TB/s.  The work itself is 3 (q8) or 5 (fx)
// native shared 32-bit adds per (row in a channel, feature).
//
// Design (PERF.md section 6 has the readings behind each part):
//  1. Fill the SM.  A block owns a GROUP of cg channels x fg features and
//     keeps only their histograms in shared memory: per (channel, feature)
//     B x 20 bytes for fx (int64 g and h, int32 count) and B x 12 for q8
//     (int32 g, h and count).  ops/histogram_cuda.py leaf_geometry sizes
//     the groups for one resident block of 1024 threads: 32 warps on every
//     SM.  It takes the fewest block columns, then the most channels per
//     block (the fastest group of every form in a replayed wave iteration
//     while the adds were compare-and-swap loops; PERF.md section 6 has
//     the groups timed on this body).  A row outside the block's channels
//     costs one byte.
//  2. Native shared adds.  sm_90a has no native 64-bit shared atomicAdd:
//     it compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64) that
//     spins on every hot bin.  Every add here is a native 32-bit one on a
//     32-bit shared address: q8 sums g and h in separate int32 words
//     (three reductions with the count); fx adds each 64-bit weight as two
//     halves, the low one returning its old value (the four features' low
//     halves first, so their returns come back together) and its carry
//     going with the high one, exact mod 2^64.  The other form, 64-bit
//     words through a generic address (q8: (g << 32) + h), compiles to
//     ATOM.E.ADD.64 with a compare-and-swap fallback behind its predicate,
//     so the loop stays in the code; on the even mix q8's loses 6% at
//     B=256 and wins 4% packed, fx's wins 1-9% (both win 26-36% on a
//     90%-skewed mix).  scripts/hist_leaves_variants.cu builds it.
//  3. Rows in flight, and full warps at the adds.  Each warp reads the
//     channel bytes of 128 rows per step with one 4-byte load per lane
//     (four steps' loads issued together), and compacts the rows that fall
//     in the block's channels into a per-warp queue in shared memory, in
//     row order (each lane's slot from the warp's ballots of its four row
//     slots), so a round's rows share sectors.  Whenever the queue holds
//     32 rows, every lane takes one: its weights (q8: three bytes, fx:
//     three int64) and, beside them, its first four features' bins, then
//     the adds and the next features.  So every add instruction carries 32
//     rows, however few rows a channel group holds, and a step whose rows
//     are all elsewhere costs one load.  A row's channel and weights are
//     read once per feature group: fg features share them.
//  4. The grid.  A single launch is (block columns, row chunks), sized
//     from the SM count so that it is ONE resident round.  The model-axis
//     form (the reference's vmap of these entry points: L lanes, each its
//     own weights and channels, over the shared bins) is one grid of
//     (block column, lane, row chunk) items: the blocks of one row chunk
//     of every lane are dispatched together, so they share its bin bytes
//     in L2, and ops/histogram_cuda.py lane_leaf_geometry cuts every lane
//     into the row chunks that fill whole resident rounds, at least four
//     where the row cap allows (at L=4 and B=256, 640 items in 5 rounds of
//     132, where 4 single launches take 4 rounds of 120; packed, 528 in
//     4).  Which lanes keep rows only the card knows: a pass over the
//     lanes' channel bytes (lanes_live_kernel) flags each lane's live
//     channels, and a block with none of its lane leaves at once.  So an
//     empty lane costs the pass, and the other lanes' items fill the
//     rounds: with fewer, longer items the live lanes' blocks of an empty
//     lane's grid still took as many rounds as four live lanes.
//  5. Each block flushes its non-zero sums once, with global reductions
//     that return nothing (red.global).
// The adds no longer set the pace on an even mix: a build that loads and
// queues every row but adds nothing (scripts/hist_leaves_variants.cu)
// takes 85-95% of the time at B=256, the channel scan alone a third of it.
//
// Times (CUDA events behind a spinning kernel, medians of two runs;
// scripts/torch_leaf_lanes_sweep.py at F=28, N=10,502,144, half the rows
// in a channel; NVIDIA H100 80GB HBM3, 700.00 W), the parent's (the
// compare-and-swap adds, lanes on grid z) in the same call:
//   hist_leaves_q8     B=256  0.643 ms  (parent 0.919, index_add_ 5.315)
//   hist_leaves_fx     B=256  0.739 ms  (1.004, int64 3.016)
//   hist_leaves_q8_p4  B=16   0.362 ms  (0.575, 8.072)
//   hist_leaves_fx_p4  B=16   0.329 ms  (0.621, 5.884)
//   the lanes forms at L=4, the live-channel pass included: q8 2.330
//   (3.547; 4 single launches 2.563), fx 2.547 (4.089; 2.940), packed q8
//   1.311 (2.155; 1.431), packed fx 1.178 (2.309; 1.296); the pass alone
//   0.03.  PERF.md section 6 has every mix and the variants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;     // 64 registers a thread: one block per SM
constexpr int kLaneRows = 4;       // rows of one lane per warp step
constexpr int kWarpRows = 32 * kLaneRows;
constexpr int kQueue = kWarpRows + 32;   // queue entries per warp
constexpr int kAhead = 4;          // warp steps whose channels load at once
constexpr int kChBits = 7;         // queue entry: row << 7 | channel
constexpr int kLiveThreads = 256;  // lanes_live_kernel's block
constexpr int kLiveLoads = 4;      // its 16-byte loads a thread, at once
constexpr int kLiveWords = kLiveLoads * kLiveThreads;   // a block's

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

template <bool PACKED>
__device__ __forceinline__ int bin_of(const uint8_t* __restrict__ col,
                                      long long row) {
  if constexpr (PACKED) {
    return (__ldg(col + (row >> 1)) >> ((row & 1) * 4)) & 15;
  } else {
    return __ldg(col + row);
  }
}

// Shared-window addresses are 32 bits (one register).  The native
// 32-bit shared adds: with the old value back (ATOMS.ADD), and with none
// (its result unused).
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

// Into device memory (the result): reductions with no return.
__device__ __forceinline__ void red_global(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "l"(v)
               : "memory");
}

__device__ __forceinline__ void red_global(int* p, int v) {
  asm volatile("red.global.add.u32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "r"(v)
               : "memory");
}

// The block's shared histogram of Ea = cg * fg * B entries, entry
// (ci, k, b) = (ci * nf + k) * B + b: q8 int32 g[Ea] and h[Ea], fx int64
// g[Ea] and h[Ea]; then uint32 count[Ea].  base and cnt: the arrays'
// shared addresses.
struct Hist {
  unsigned int base;
  unsigned int cnt;
  int Ea;
};

template <typename W>
__device__ __forceinline__ Hist hist_of(unsigned char* smem, int Ea) {
  constexpr bool Q8 = sizeof(W) == 1;
  Hist H;
  H.base = sh(smem);
  H.Ea = Ea;
  H.cnt = H.base + (unsigned int)Ea * (Q8 ? 8u : 16u);
  return H;
}

// One row's weights (g, h, n) into the entries e[i] of the four features
// of a group whose ok[i] holds.  fx as 32-bit halves: the low halves of
// the group first, their old values coming back together, then the high
// halves with their carries (exact mod 2^64, so the sums stay bitwise).
template <typename W>
__device__ __forceinline__ void add_group(const Hist& H, const int* e,
                                          const bool* ok, long long g,
                                          long long h, unsigned int n) {
  if constexpr (sizeof(W) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      if (g) red_sh(H.base + 4u * e[i], (unsigned int)g);
      if (h) red_sh(H.base + 4u * (H.Ea + e[i]), (unsigned int)h);
      if (n) red_sh(H.cnt + 4u * e[i], n);
    }
  } else {
    const unsigned int glo = (unsigned int)g, hlo = (unsigned int)h;
    unsigned int og[4], oh[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      og[i] = ok[i] && glo ? atom_sh(H.base + 8u * e[i], glo) : 0u;
      oh[i] = ok[i] && hlo ? atom_sh(H.base + 8u * (H.Ea + e[i]), hlo) : 0u;
    }
    const unsigned int ghi = (unsigned int)((unsigned long long)g >> 32);
    const unsigned int hhi = (unsigned int)((unsigned long long)h >> 32);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const unsigned int ug = ghi + (og[i] + glo < og[i] ? 1u : 0u);
      const unsigned int uh = hhi + (oh[i] + hlo < oh[i] ? 1u : 0u);
      if (ug) red_sh(H.base + 8u * e[i] + 4u, ug);
      if (uh) red_sh(H.base + 8u * (H.Ea + e[i]) + 4u, uh);
      if (n) red_sh(H.cnt + 4u * e[i], n);
    }
  }
}

// One queued row (queue entry q: row - r0 << kChBits | channel in the
// group): its weights once, then per group of four features of the
// block's its bins and adds; the first group's bins load beside the
// weights, before the test that skips a row with no weight (out of the
// bag).
template <typename W, bool PACKED>
__device__ __forceinline__ void add_row(
    const Hist& H, const uint8_t* __restrict__ bins,
    const W* __restrict__ w, long long fstride, long long N, int B, int nf,
    unsigned int q, long long r0) {
  const long long row = r0 + (q >> kChBits);
  const int base = (int)(q & ((1u << kChBits) - 1)) * nf * B;
  const long long g = __ldg(w + row);
  const long long h = __ldg(w + N + row);
  unsigned int n;
  if constexpr (sizeof(W) == 1)
    n = (unsigned int)(int)__ldg(w + 2 * N + row);
  else
    n = (unsigned int)__ldg(w + 2 * N + row);
  for (int k = 0; k < nf; k += 4) {
    int e[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b =
          k + i < nf ? bin_of<PACKED>(bins + (k + i) * fstride, row) : B;
      ok[i] = b < B;   // outside the histogram, as in plain
      e[i] = base + (k + i) * B + b;
    }
    if ((g | h) == 0 && n == 0u) return;
    add_group<W>(H, e, ok, g, h, n);
  }
}

// What a block of the grid covers: channels [c0, c0 + nc) and features
// [f0, f0 + nf) of block column blockIdx.x (channel groups fastest), rows
// [r0, r1) of row chunk blockIdx.z.
struct Block {
  int c0, f0, nc, nf;
  long long r0, r1;
};

__device__ __forceinline__ Block block_of(int F, long long N, int K, int cg,
                                          int fg, long long chunk_rows) {
  const int c_groups = (K + cg - 1) / cg;
  Block k;
  k.c0 = (blockIdx.x % c_groups) * cg;
  k.f0 = (blockIdx.x / c_groups) * fg;
  k.nc = min(cg, K - k.c0);
  k.nf = min(fg, F - k.f0);
  k.r0 = (long long)blockIdx.z * chunk_rows;
  k.r1 = min(N, k.r0 + chunk_rows);
  return k;
}

// The model-axis form: lane blockIdx.y's weights, channels and output.
template <typename W>
__device__ __forceinline__ void lane_inputs(
    const long long* lanes, int L, const W* __restrict__& w,
    const int8_t* __restrict__& ch, void* __restrict__& out, int K, int F,
    int B) {
  const int y = blockIdx.y;
  w = reinterpret_cast<const W*>(lanes[y]);
  ch = reinterpret_cast<const int8_t*>(lanes[L + y]);
  out = static_cast<unsigned char*>(out) +
        (long long)y * K * F * B * 3 * (sizeof(W) == 1 ? 4 : 8);
}

// The channel scan of one warp over the block's rows [k.r0, k.r1): it
// reads the channel bytes of 128 rows per step, one 4-byte load per lane
// (kAhead steps' loads issued together), and queues the rows of the
// block's channels as entries row - r0 << kChBits | channel - c0, in row
// order (each lane's slot from the warp's ballots of its four row
// slots).  Whenever the queue holds 32 rows every lane takes one,
// row(entry); at the end the first lanes take the rest.
template <typename Row>
__device__ __forceinline__ void scan_rows(const int8_t* __restrict__ ch,
                                          const Block& k, bool vec,
                                          unsigned int* queue, Row row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long step = (long long)(blockDim.x >> 5) * kWarpRows;
  int qn = 0;   // rows queued by this warp (the same in every lane)
  for (long long t = k.r0 + (long long)warp * kWarpRows; t < k.r1;
       t += kAhead * step) {
    unsigned int cv[kAhead];   // kAhead steps' channels, loaded together
#pragma unroll
    for (int p = 0; p < kAhead; ++p)
      cv[p] = load_ch4(ch, t + p * step + lane * kLaneRows, k.r1, vec);
#pragma unroll
    for (int p = 0; p < kAhead; ++p) {
      const long long tp = t + p * step;
      if (tp >= k.r1) break;
      // queue the rows of this block's channels, in row order
      unsigned int act = 0u;
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        const int c = (int)(signed char)(cv[p] >> (8 * j)) - k.c0;
        if ((unsigned int)c < (unsigned int)k.nc) act |= 1u << j;
      }
      // this lane's first queue slot: the rows before it in the warp's
      // ballot of each of the four row slots
      const unsigned int below = (1u << lane) - 1u;
      int pos = qn, total = 0;
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        const unsigned int m = __ballot_sync(0xffffffffu, (act >> j) & 1u);
        pos += __popc(m & below);
        total += __popc(m);
      }
      const long long rl = tp + lane * kLaneRows - k.r0;
#pragma unroll
      for (int j = 0; j < kLaneRows; ++j) {
        if ((act >> j) & 1u) {
          const int c = (int)(signed char)(cv[p] >> (8 * j)) - k.c0;
          queue[pos++] = ((unsigned int)(rl + j) << kChBits) | (unsigned int)c;
        }
      }
      qn += total;
      __syncwarp();
      while (qn >= 32) {   // full rounds, taken from the end of the queue
        qn -= 32;
        row(queue[qn + lane]);
      }
      __syncwarp();
    }
  }
  if (lane < qn) row(queue[lane]);
}

// The model-axis form's skip: a block of a lane that keeps no row in its
// channels (live: the lanes' (L, K) flags from lanes_live_kernel) leaves
// before it touches shared memory; every block of the single forms
// (live null) works.
__device__ __forceinline__ bool block_live(const int* __restrict__ live,
                                          int K, const Block& k) {
  return live == nullptr ||
         __syncthreads_or(threadIdx.x < k.nc &&
                          live[(long long)blockIdx.y * K + k.c0 +
                               threadIdx.x] != 0);
}

// Entry (ci, kf, b) of the block's E = nc * nf * B live entries, i, to
// its place in out (K, F, B, 3).
__device__ __forceinline__ long long out_of(const Block& k, int F, int B,
                                            int i) {
  const int b = i % B;
  const int q = i / B;
  return (((long long)(k.c0 + q / k.nf) * F + (k.f0 + q % k.nf)) * B + b) *
         3;
}

// bins: (F, N) uint8 feature-major, or (F, N/2) nibble-packed bytes when
// PACKED.  w: (wrows, N) weights, rows 0..2 are (g, h, count).  ch: (N,)
// int8 leaf channel.  out: (K, F, B, 3), int32 (q8) or int64 (fx).
// Block (x, y, z): block column x (block_of), lane y (the lanes form;
// else 0), row chunk z: the blocks of one row chunk, over every lane, run
// together, so they share the chunk's bin bytes in L2.
template <typename W, bool PACKED>
__global__ void __launch_bounds__(kThreads)
hist_leaves_kernel(const uint8_t* __restrict__ bins, const W* __restrict__ w,
                   const int8_t* __restrict__ ch, void* __restrict__ out,
                   int F, long long N, int B, int K, int cg, int fg,
                   long long chunk_rows, int vec,
                   const long long* __restrict__ lanes, int L,
                   const int* __restrict__ live) {
  constexpr bool Q8 = sizeof(W) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) lane_inputs<W>(lanes, L, w, ch, out, K, F, B);
  const Block k = block_of(F, N, K, cg, fg, chunk_rows);
  if (!block_live(live, K, k)) return;
  const int E = k.nc * k.nf * B;
  const int Ea = cg * fg * B;
  const Hist H = hist_of<W>(smem, Ea);
  unsigned int* cnt =
      reinterpret_cast<unsigned int*>(smem + (size_t)Ea * (Q8 ? 8 : 16));
  unsigned int* queue = cnt + Ea + (threadIdx.x >> 5) * kQueue;
  // zero the (g, h) words, then the live counts
  unsigned int* words = reinterpret_cast<unsigned int*>(smem);
  for (int i = threadIdx.x; i < Ea * (Q8 ? 2 : 4); i += blockDim.x)
    words[i] = 0u;
  for (int i = threadIdx.x; i < E; i += blockDim.x) cnt[i] = 0u;
  __syncthreads();

  const long long fstride = PACKED ? N / 2 : N;   // bin bytes per feature
  const uint8_t* col0 = bins + (long long)k.f0 * fstride;
  scan_rows(ch, k, vec != 0, queue, [&](unsigned int q) {
    add_row<W, PACKED>(H, col0, w, fstride, N, B, k.nf, q, k.r0);
  });
  __syncthreads();

  // flush: the non-zero sums as reductions with no return
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const long long o = out_of(k, F, B, i);
    const unsigned int n = cnt[i];
    if constexpr (Q8) {
      const int* a = reinterpret_cast<const int*>(smem);
      int* o32 = static_cast<int*>(out) + o;
      if (a[i]) red_global(o32, a[i]);
      if (a[Ea + i]) red_global(o32 + 1, a[Ea + i]);
      if (n) red_global(o32 + 2, (int)n);
    } else {
      const unsigned long long* a =
          reinterpret_cast<const unsigned long long*>(smem);
      unsigned long long* o64 = static_cast<unsigned long long*>(out) + o;
      if (a[i]) red_global(o64, a[i]);
      if (a[Ea + i]) red_global(o64 + 1, a[Ea + i]);
      if (n) red_global(o64 + 2, (unsigned long long)n);
    }
  }
}

// The lanes' live channels: live[y * K + c] = 1 where lane y keeps a row
// in channel c (live zero-filled by the caller).  Grid (blocks, L): each
// block reads its lane's channel bytes as 16-byte words, kLiveLoads of
// them a thread at once (the bytes before the first 16-byte boundary and
// after the last whole word go to block 0's first warp one at a time),
// marks the channels it meets in shared memory, then stores its marks
// (plain stores of 1, whose races are harmless).
__device__ __forceinline__ void mark_live(int* seen, unsigned int v, int K) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = (int)(signed char)(v >> (8 * j));
    if ((unsigned int)c < (unsigned int)K) seen[c] = 1;
  }
}

__global__ void __launch_bounds__(kLiveThreads)
lanes_live_kernel(const long long* __restrict__ lanes, int L, long long N,
                  int K, int* __restrict__ live) {
  __shared__ int seen[1 << kChBits];
  const uint8_t* ch = reinterpret_cast<const uint8_t*>(lanes[L + blockIdx.y]);
  for (int i = threadIdx.x; i < K; i += blockDim.x) seen[i] = 0;
  __syncthreads();
  const long long head =
      min(N, (long long)((16u - ((uintptr_t)ch & 15u)) & 15u));
  const long long words = (N - head) >> 4;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    for (long long r = threadIdx.x; r < head; r += 32)
      mark_live(seen, 0xffffff00u | ch[r], K);
    for (long long r = head + words * 16 + threadIdx.x; r < N; r += 32)
      mark_live(seen, 0xffffff00u | ch[r], K);
  }
  const uint4* body = reinterpret_cast<const uint4*>(ch + head);
  const long long stride = (long long)gridDim.x * kLiveWords;
  for (long long i = (long long)blockIdx.x * kLiveWords + threadIdx.x;
       i < words; i += stride) {
    uint4 v[kLiveLoads];
#pragma unroll
    for (int p = 0; p < kLiveLoads; ++p) {
      const long long at = i + p * kLiveThreads;
      v[p] = at < words ? __ldg(body + at)
                        : make_uint4(~0u, ~0u, ~0u, ~0u);
    }
#pragma unroll
    for (int p = 0; p < kLiveLoads; ++p) {
      mark_live(seen, v[p].x, K);
      mark_live(seen, v[p].y, K);
      mark_live(seen, v[p].z, K);
      mark_live(seen, v[p].w, K);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    if (seen[i]) live[(long long)blockIdx.y * K + i] = 1;
}

// lanes: null for one lane, else the device table (2, L) of each lane's
// weight and channel pointers, with out the lanes' (L, K, F, B, 3).
template <typename W, bool PACKED>
int launch(const void* bins, const void* w, const void* ch, void* out, int F,
           long long N, int B, int K, int cg, int fg, int chunks,
           long long chunk_rows, int vec, void* stream,
           const long long* lanes = nullptr, int L = 1,
           const int* live = nullptr) {
  if (F <= 0 || N <= 0 || K <= 0 || L <= 0) return 0;
  if (L > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  if (cg >= (1 << kChBits) || chunk_rows > (1LL << (32 - kChBits)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cg * fg * B * (sizeof(W) == 1 ? 12 : 20) +
                      (size_t)(kThreads / 32) * kQueue * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hist_leaves_kernel<W, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int combos = ((K + cg - 1) / cg) * ((F + fg - 1) / fg);
  dim3 grid(combos, L, chunks);
  hist_leaves_kernel<W, PACKED>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(bins), static_cast<const W*>(w),
          static_cast<const int8_t*>(ch), out, F, N, B, K, cg, fg,
          chunk_rows, vec, lanes, L, live);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// All four forms take: bins, weights, ch, out (zero-filled by the caller),
// F, N (rows), B, K, cg, fg (channels and features per block), chunks (row
// chunks), chunk_rows (a multiple of 16, at most 2^25), vec (1: ch is
// 4-byte aligned), stream.  Blocks of 1024 threads.

// 42-channel quantized histogram: wch (8, N) int8 [g_q, h_q, count, 0...],
// out (K, F, B, 3) int32; chunk_rows <= 2^24 (leaf_geometry's cap).
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
// table [weight pointer of lane l, channel pointer of lane l]; live: the
// lanes' (L, K) int32 live-channel flags (leaf_lanes_live, on the same
// stream); out (L, K, F, B, 3), zero-filled by the caller; vec: every
// lane's ch is 4-byte aligned; chunks and chunk_rows: each lane's row
// chunks (lane_leaf_geometry).  Grid (combos, L, chunks): every chunk's
// blocks of every lane together, those of a lane with no row in their
// channels leaving at once; the integer sums equal each lane's single
// launch's, bit for bit.
int hist_leaves_q8_lanes(const void* bins, const void* lanes,
                         const void* live, void* out, int L, int F,
                         long long N, int B, int K, int cg, int fg,
                         int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  const int* v = static_cast<const int*>(live);
  return packed ? launch<int8_t, true>(bins, nullptr, nullptr, out, F, N, B,
                                       K, cg, fg, chunks, chunk_rows, vec,
                                       stream, t, L, v)
                : launch<int8_t, false>(bins, nullptr, nullptr, out, F, N, B,
                                        K, cg, fg, chunks, chunk_rows, vec,
                                        stream, t, L, v);
}

int hist_leaves_fx_lanes(const void* bins, const void* lanes,
                         const void* live, void* out, int L, int F,
                         long long N, int B, int K, int cg, int fg,
                         int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  const int* v = static_cast<const int*>(live);
  return packed ? launch<long long, true>(bins, nullptr, nullptr, out, F, N,
                                          B, K, cg, fg, chunks, chunk_rows,
                                          vec, stream, t, L, v)
                : launch<long long, false>(bins, nullptr, nullptr, out, F, N,
                                           B, K, cg, fg, chunks, chunk_rows,
                                           vec, stream, t, L, v);
}

// The lanes' live channels: live (L, K) int32, zero-filled by the
// caller, gets 1 where lane l's channels (the lanes table's second row,
// any alignment) hold channel c for some row; K < 128.
int leaf_lanes_live(const void* lanes, void* live, int L, long long N, int K,
                    void* stream) {
  if (L <= 0 || N <= 0 || K <= 0) return 0;
  if (L > 65535 || K >= (1 << kChBits)) return (int)cudaErrorInvalidValue;
  const long long blocks = (N / 16 + kLiveWords - 1) / kLiveWords;
  dim3 grid((unsigned int)(blocks < 1 ? 1 : blocks < 4096 ? blocks : 4096),
            L);
  lanes_live_kernel<<<grid, kLiveThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(lanes), L, N, K,
      static_cast<int*>(live));
  return (int)cudaGetLastError();
}

}  // extern "C"

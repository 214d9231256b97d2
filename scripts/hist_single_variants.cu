// Two designs of lightgbm_tpu_torch/csrc/hist_single.cu that lost to it
// on the H100, kept so that scripts/torch_single_lanes_sweep.py can time
// them again beside the package's build (PERF.md section 6 has their
// times).  The package never builds this file.
//
//  * ring (the uint8 one-tile forms, layouts 0-3): one copying warp keeps
//    a ring of row tiles in flight with bulk asynchronous copies
//    (cp.async.bulk, mbarrier completion) and the other warps only decode
//    and add.
//  * ship (the uint16 forms past one bin tile): each block stages its
//    remote adds in their owners' shared memory, and the owners add them
//    there each round.
//
// The file includes the package's source with its four launching entry
// points renamed (..._base) and exports them again: each launches its
// variant where that applies and otherwise the package's own kernel.
// Build it as the sweep does:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhs_lost.so scripts/hist_single_variants.cu

#define hist_single hist_single_base
#define hist_single_lanes hist_single_lanes_base
#define hist_single_u16 hist_single_u16_base
#define hist_single_lanes_u16 hist_single_lanes_u16_base
#include "../lightgbm_tpu_torch/csrc/hist_single.cu"
#undef hist_single
#undef hist_single_lanes
#undef hist_single_u16
#undef hist_single_lanes_u16

namespace {

constexpr int kShipHead = 192;    // bytes of a shipping block's counters
constexpr int kShipRecord = 20;   // bytes of a shipped add (entry, g, h)
constexpr int kShipMaxCap = 1024; // records a block stages for one owner
constexpr int kRingStages = 3;    // row tiles in flight in the ring
constexpr int kRingMaxRows = 2048;
constexpr int kNoVariant = -1;    // the variant does not apply

// Past one bin tile (uint16): stage and ship.  Every block of the cluster
// walks its span's rows, one row a thread a round, and sends each code's
// add to the block that keeps its bin: its own adds straight into its
// histogram; every other add stored into the owner's shared memory, in
// the owner's box for this sender (entry with the count in bit 31, g, h;
// remote stores, which do not wait), its slot from a counter in the
// sender's own shared memory.  At the round's end the cluster syncs, each
// block reads the other blocks' counters for it, adds its boxes into its
// own histogram from its own shared memory, and a second sync frees the
// boxes.  So every add lands in its owner's shared memory with native
// shared atomics.  A box that fills (codes crowded on one owner's bins)
// sends its overflow straight into the output with global reductions
// (never as 64-bit DSM adds onto entries that take 32-bit halves):
// nothing waits on room and nothing drops.  Every block of a
// cluster walks the same number of rounds (its span's share), so every
// block reaches every barrier.  Both layouts (bins[f * sf + r * sn]).  The
// next round's row is loaded before the exchange.
__global__ void __launch_bounds__(1024)
hist_single_ship(const uint16_t* __restrict__ bins_, long long sf,
                 long long sn, const long long* __restrict__ w_,
                 long long ws_, unsigned long long* __restrict__ out_,
                 int F, long long n, int B, int fg, int Bt, int cs, int cap,
                 long long chunk_rows, const long long* __restrict__ lanes,
                 const long long* __restrict__ items, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Span<uint16_t> sp = span_of<uint16_t>(bins_, w_, ws_, out_, F, n,
                                              B, chunk_rows, lanes, items,
                                              L, cs, rank);
  const int tiles = (B + Bt - 1) / Bt;
  const Place P = place_of<true>(F, B, fg, tiles, cs, sp.group, rank);
  const Hist H = zero_hist(smem, fg, Bt);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(
      smem + (((size_t)2 * H.E * 8 + (size_t)H.E * 4 + 15) & ~(size_t)15));
  unsigned int* pref = cnt + kMaxCluster;   // [kMaxCluster + 1]
  unsigned long long* bg =
      reinterpret_cast<unsigned long long*>(cnt + kShipHead / 4);
  unsigned long long* bh = bg + (long long)cs * cap;
  unsigned int* be = reinterpret_cast<unsigned int*>(bh + (long long)cs * cap);
  if (threadIdx.x < kMaxCluster) cnt[threadIdx.x] = 0u;
  cluster.sync();   // every histogram and counter of the cluster zeroed
  const Route R = route(B, fg, tiles, cs, 0, rank);
  const int ng = P.ng;
  const uint16_t* base = sp.bins + (long long)P.g0 * sf;
  unsigned long long* og = sp.out + (long long)P.g0 * B * 3;
  const long long rounds = (sp.share + blockDim.x - 1) / blockDim.x;
  long long r = sp.r0 + threadIdx.x;
  long long g = 0, h = 0, c = 0;
  if (r < sp.r1) {
    g = __ldg(sp.w + r);
    h = __ldg(sp.w + sp.ws + r);
    c = __ldg(sp.w + 2 * sp.ws + r);
  }
  for (long long q = 0; q < rounds; ++q) {
    if (r < sp.r1 && ((g | h) != 0 || c != 0)) {
      const uint16_t* p = base + r * sn;
      for (int k = 0; k < ng; ++k) {
        const unsigned int v = __ldg(p + (long long)k * sf);
        if (v >= R.B) continue;
        int e;
        const int o = owner_of(R, H.S, k, v, &e);
        if (o == rank) {
          add<true>(H, e, g, h, (unsigned int)c);
          continue;
        }
        const unsigned int s = atomicAdd(cnt + o, 1u);
        if (s < (unsigned int)cap) {
          const long long at = (long long)rank * cap + s;
          cluster.map_shared_rank(be, o)[at] =
              (unsigned int)e | ((unsigned int)c << 31);
          cluster.map_shared_rank(bg, o)[at] = (unsigned long long)g;
          cluster.map_shared_rank(bh, o)[at] = (unsigned long long)h;
        } else {
          unsigned long long* q = og + ((long long)k * B + v) * 3;
          if (g) red_global(q, (unsigned long long)g);
          if (h) red_global(q + 1, (unsigned long long)h);
          if (c) red_global(q + 2, (unsigned long long)c);
        }
      }
    }
    // the next round's row, loaded before the exchange
    r += blockDim.x;
    g = h = c = 0;
    if (r < sp.r1) {
      g = __ldg(sp.w + r);
      h = __ldg(sp.w + sp.ws + r);
      c = __ldg(sp.w + 2 * sp.ws + r);
    }
    cluster.sync();   // every box of the round filled, every overflow landed
    if (threadIdx.x < 32) {
      // warp 0: the records each rank staged for this block, as offsets
      unsigned int m = 0u;
      if ((int)threadIdx.x < cs && (int)threadIdx.x != rank)
        m = min(cluster.map_shared_rank(cnt, (int)threadIdx.x)[rank],
                (unsigned int)cap);
      unsigned int x = m;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned int y = __shfl_up_sync(0xffffffffu, x, d);
        if ((int)threadIdx.x >= d) x += y;
      }
      if (threadIdx.x < kMaxCluster) pref[threadIdx.x + 1] = x;
      if (threadIdx.x == 0) pref[0] = 0u;
    }
    __syncthreads();
    const unsigned int total = pref[cs];
    int s = 0;
    for (unsigned int i = threadIdx.x; i < total; i += blockDim.x) {
      while (pref[s + 1] <= i) ++s;
      const long long at = (long long)s * cap + (i - pref[s]);
      const unsigned int ec = be[at];
      add<true>(H, (int)(ec & 0x7fffffffu), (long long)bg[at],
                (long long)bh[at], ec >> 31);
    }
    cluster.sync();   // every box of the round read
    if (threadIdx.x < kMaxCluster) cnt[threadIdx.x] = 0u;
    __syncthreads();
  }
  // after the last round's syncs every add into this block has landed
  flush(H, sp.out, P.f0, P.nf, B, P.b0, P.nbt, tiles);
}

// ---- the ring: bulk asynchronous copies and their barriers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

// Wait for the barrier's phase of this parity to complete.  A wait that
// never ends traps (a launch error the wrapper raises) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned int parity) {
  const uint32_t a = smem_u32(b);
  for (long long spin = 0;; ++spin) {
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (ok) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// A bulk copy of the 16-byte aligned bytes around [src, src + bytes) into
// dst (16-byte aligned), completing on `bar`; returns the bytes copied.
// The rounding stays inside the source's allocation (device allocations
// are 512-byte aligned and sized).
__device__ __forceinline__ unsigned int bulk(void* dst, const void* src,
                                             long long bytes, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const unsigned int n =
      (unsigned int)(((a + (uintptr_t)bytes + 15) & ~(uintptr_t)15) - lo);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(reinterpret_cast<const void*>(lo))),
      "r"(n), "r"(smem_u32(bar))
      : "memory");
  return n;
}

__device__ __forceinline__ unsigned int bulk_bytes(const void* src,
                                                   long long bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return (unsigned int)(((a + (uintptr_t)bytes + 15) & ~(uintptr_t)15) -
                        (a & ~(uintptr_t)15));
}

// The uint8 one-tile forms through the ring.  Warp 0's
// first lane keeps kRingStages tiles of R rows in flight: for ROWS the
// tile's whole rows (sf == 1), for FEATS each of the group's features'
// runs, and each weight channel's run, one bulk copy each (1-D, no tensor
// map), completing on the stage's `full` barrier.  The other warps only
// decode and add: unit u of a tile is (row, word of 4 features) (ROWS with
// words; else (row, feature) for ROWS and (row, 4 features) for FEATS),
// consecutive threads on consecutive units, so a warp's adds spread over
// the features; each warp arrives on the stage's `empty` barrier when done
// and the copier refills the stage.  Shared memory: the histogram, the
// barriers, then kRingStages stages of codes and three weight runs, each
// run's copy 16-byte aligned (its first byte at the source's offset mod
// 16).  An empty span copies nothing and flushes zeros.
template <bool FEATS>
__global__ void __launch_bounds__(1024)
hist_single_ring(const uint8_t* __restrict__ bins_, long long sf,
                 long long sn, const long long* __restrict__ w_,
                 long long ws_, unsigned long long* __restrict__ out_, int F,
                 long long n, int B, int fg, long long chunk_rows, int words,
                 int R, const long long* __restrict__ lanes,
                 const long long* __restrict__ items, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Span<uint8_t> sp = span_of<uint8_t>(bins_, w_, ws_, out_, F, n, B,
                                            chunk_rows, lanes, items, L, 1,
                                            0);
  const Place P = place_of<false>(F, B, fg, 1, 1, sp.group, 0);
  const int ng = P.ng;
  if (!FEATS && items)
    words = words && (reinterpret_cast<uintptr_t>(sp.bins) & 3) == 0;
  const Hist H = zero_hist(smem, fg, B);
  unsigned char* tail =
      smem + (((size_t)2 * H.E * 8 + (size_t)H.E * 4 + 15) & ~(size_t)15);
  uint64_t* full = reinterpret_cast<uint64_t*>(tail);
  uint64_t* empty = full + kRingStages;
  unsigned char* ring = tail + 64;
  const long long cb = FEATS ? (long long)fg * (R + 32) : (long long)R * sn + 32;
  const long long wb = 8LL * R + 16;
  const long long stage = cb + 3 * wb;
  const int consumers = (int)(blockDim.x >> 5) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(full + s, 1u);
      mbar_init(empty + s, (unsigned int)consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the histogram zeroed, the barriers set
  const long long r0 = sp.r0, r1 = sp.r1;
  const long long tiles = r1 > r0 ? (r1 - r0 + R - 1) / R : 0;
  const uint8_t* gb = sp.bins + (long long)P.g0 * sf;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (long long i = 0; i < tiles; ++i) {
        const int s = (int)(i % kRingStages);
        if (i >= kRingStages)
          mbar_wait(empty + s, (unsigned int)((i / kRingStages - 1) & 1));
        const long long t0 = r0 + i * R;
        const long long nr = min((long long)R, r1 - t0);
        unsigned char* st = ring + s * stage;
        unsigned int bytes = 0;
        if constexpr (FEATS) {
          for (int k = 0; k < ng; ++k) bytes += bulk_bytes(gb + k * sf + t0, nr);
        } else {
          bytes += bulk_bytes(sp.bins + t0 * sn, nr * sn);
        }
        for (int c = 0; c < 3; ++c)
          bytes += bulk_bytes(sp.w + c * sp.ws + t0, 8 * nr);
        mbar_expect(full + s, bytes);
        if constexpr (FEATS) {
          for (int k = 0; k < ng; ++k)
            bulk(st + (long long)k * (R + 32), gb + k * sf + t0, nr, full + s);
        } else {
          bulk(st, sp.bins + t0 * sn, nr * sn, full + s);
        }
        for (int c = 0; c < 3; ++c)
          bulk(st + cb + c * wb, sp.w + c * sp.ws + t0, 8 * nr, full + s);
      }
    }
  } else {
    const Route Rt = route(B, fg, 1, 1, 0, 0);
    const int tid = (int)threadIdx.x - 32;
    const int nthr = (int)blockDim.x - 32;
    const int nw = (!FEATS && words) ? ng / 4 : 0;
    const int per_row = FEATS ? (ng + 3) / 4 : nw + (ng - 4 * nw);
    const unsigned int mper = magic((unsigned int)per_row);
    for (long long i = 0; i < tiles; ++i) {
      const int s = (int)(i % kRingStages);
      mbar_wait(full + s, (unsigned int)((i / kRingStages) & 1));
      const long long t0 = r0 + i * R;
      const int nr = (int)min((long long)R, r1 - t0);
      const unsigned char* st = ring + s * stage;
      const long long* wg = reinterpret_cast<const long long*>(
          st + cb + (reinterpret_cast<uintptr_t>(sp.w + t0) & 15));
      const long long* wh = reinterpret_cast<const long long*>(
          st + cb + wb + (reinterpret_cast<uintptr_t>(sp.w + sp.ws + t0) & 15));
      const long long* wc = reinterpret_cast<const long long*>(
          st + cb + 2 * wb +
          (reinterpret_cast<uintptr_t>(sp.w + 2 * sp.ws + t0) & 15));
      const int units = nr * per_row;
      for (int u = tid; u < units; u += nthr) {
        const int j = (int)quot((unsigned int)u, (unsigned int)per_row, mper);
        const int q = u - j * per_row;
        const long long g = wg[j], h = wh[j];
        const unsigned int c = (unsigned int)wc[j];
        if ((g | h) == 0 && c == 0u) continue;
        if constexpr (FEATS) {
          const int k1 = min(ng, 4 * q + 4);
          for (int k = 4 * q; k < k1; ++k) {
            const unsigned char* col =
                st + (long long)k * (R + 32) +
                (reinterpret_cast<uintptr_t>(gb + k * sf + t0) & 15);
            put<false, false>(H, Rt, nullptr, k, col[j], g, h, c);
          }
        } else {
          const unsigned char* row =
              st + (reinterpret_cast<uintptr_t>(sp.bins + t0 * sn) & 15) +
              (long long)j * sn + P.g0;
          if (q < nw) {
            const unsigned int v =
                *reinterpret_cast<const unsigned int*>(row + 4 * q);
#pragma unroll
            for (int b = 0; b < 4; ++b)
              put<false, false>(H, Rt, nullptr, 4 * q + b,
                                (v >> (8 * b)) & 255u, g, h, c);
          } else {
            const int k = 4 * nw + (q - nw);
            put<false, false>(H, Rt, nullptr, k, row[k], g, h, c);
          }
        }
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
    }
  }
  __syncthreads();   // every add landed
  flush(H, sp.out, P.f0, P.nf, B, 0, B, 1);
}


// A shipping block's shared memory: its histogram (16-byte aligned), the
// counters, and cs boxes of cap records.
size_t ship_smem(int fg, int Bt, int cs, int cap) {
  return ((smem_bytes(fg, Bt) + 15) & ~(size_t)15) + kShipHead +
         (size_t)cs * cap * kShipRecord;
}

// The records a shipping block stages for each owner: what its share of an
// SM's shared memory (per_sm blocks of `threads` an SM, each with 1 KB
// reserved) leaves past its histogram, at most kShipMaxCap.
int ship_cap(int fg, int Bt, int cs, int threads) {
  int optin = 0, sm = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const int per_sm = threads >= 1024 ? 1 : 1024 / threads;
  const long long budget =
      std::min((long long)optin, (long long)sm / per_sm - 1024);
  const long long left = budget - (long long)ship_smem(fg, Bt, cs, 0);
  return (int)std::max(
      0LL, std::min((long long)kShipMaxCap, left / (cs * kShipRecord)));
}


// The ring's rows a tile for a uint8 one-tile block of fg features (ROWS:
// whole rows of sn bytes; FEATS: fg runs), in what the block's share of
// an SM's shared memory leaves past its histogram: a multiple of 16, at
// most kRingMaxRows and few enough that a tile's units index in 16 bits;
// 0 (no ring) below 64.
int ring_rows(int fg, int B, long long sn, int threads, bool feats) {
  int optin = 0, sm = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const int per_sm = threads >= 1024 ? 1 : 1024 / threads;
  const long long budget =
      std::min((long long)optin, (long long)sm / per_sm - 1024) -
      (long long)((smem_bytes(fg, B) + 15) & ~(size_t)15) - 64;
  const long long a = feats ? fg + 24 : sn + 24;
  const long long b = feats ? 32LL * fg + 48 : 80;
  long long R = (budget / kRingStages - b) / a;
  R = std::min({R, (long long)kRingMaxRows, (long long)(65535 / fg)}) / 16 *
      16;
  return R >= 64 ? (int)R : 0;
}

size_t ring_smem(int fg, int B, long long sn, int R, bool feats) {
  const long long cb = feats ? (long long)fg * (R + 32) : (long long)R * sn + 32;
  return ((smem_bytes(fg, B) + 15) & ~(size_t)15) + 64 +
         (size_t)kRingStages * (size_t)(cb + 3 * (8LL * R + 16));
}


// The ring for layouts 0-3 where a tile of at least 64 rows fits, else
// kNoVariant; arguments as launch_u8's.
int launch_ring(const void* bins, long long sf, long long sn, const void* w,
                long long ws, void* out, int F, long long n, int B, int fg,
                dim3 grid, long long chunk_rows, int threads, int layout,
                const long long* lanes, const long long* items, int L,
                void* stream) {
  const bool feats = layout == 2 || layout == 3;
  const int R = (feats || (layout < 2 && sf == 1))
                    ? ring_rows(fg, B, sn, threads, feats)
                    : 0;
  if (R <= 0) return kNoVariant;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bins);
  const long long* wp = static_cast<const long long*>(w);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const size_t rs = ring_smem(fg, B, sn, R, feats);
  int err;
  if (feats) {
    if ((err = prepare(hist_single_ring<true>, rs)) != 0) return err;
    hist_single_ring<true><<<grid, threads, rs, st>>>(
        b, sf, sn, wp, ws, o, F, n, B, fg, chunk_rows, 0, R, lanes, items, L);
  } else {
    if ((err = prepare(hist_single_ring<false>, rs)) != 0) return err;
    hist_single_ring<false><<<grid, threads, rs, st>>>(
        b, sf, sn, wp, ws, o, F, n, B, fg, chunk_rows, layout == 1, R, lanes,
        items, L);
  }
  return (int)cudaGetLastError();
}

// The shipping kernel in the uint16 form's clusters (C0 as u16_config
// sets it), with its boxes in shared memory past the histogram.
int launch_ship(const U16Launch& C0, const void* bins, long long sf,
                long long sn, const void* w, long long ws, void* out, int F,
                long long n, int B, int fg, int Bt, int cs,
                long long chunk_rows, const long long* lanes,
                const long long* items, int L) {
  U16Launch C = C0;
  C.cfg.attrs = C.attr;
  const int cap = ship_cap(fg, Bt, cs, (int)C.cfg.blockDim.x);
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  C.cfg.dynamicSmemBytes = ship_smem(fg, Bt, cs, cap);
  int err = prepare(hist_single_ship, C.cfg.dynamicSmemBytes, cs);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(
      &C.cfg, hist_single_ship, static_cast<const uint16_t*>(bins), sf, sn,
      static_cast<const long long*>(w), ws,
      static_cast<unsigned long long*>(out), F, n, B, fg, Bt, cs, cap,
      chunk_rows, lanes, items, L);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

bool one_tile(int B, int Bt) {
  return B <= 0 || Bt <= 0 || (B + Bt - 1) / Bt == 1;
}

}  // namespace

extern "C" {

// The package's entry points, arguments as there.

int hist_single(const void* bins, long long sf, long long sn, const void* w,
                long long ws, void* out, int F, long long n, int B, int fg,
                int chunks, long long chunk_rows, int threads, int layout,
                void* stream) {
  if (F <= 0 || n <= 0 || fg <= 0) return 0;
  const int err = launch_ring(bins, sf, sn, w, ws, out, F, n, B, fg,
                              dim3(chunks, (F + fg - 1) / fg), chunk_rows,
                              threads, layout, nullptr, nullptr, 1, stream);
  if (err != kNoVariant) return err;
  return hist_single_base(bins, sf, sn, w, ws, out, F, n, B, fg, chunks,
                          chunk_rows, threads, layout, stream);
}

int hist_single_lanes(const void* lanes, int items, long long sf,
                      long long sn, void* out, int L, int F, int B, int fg,
                      int threads, int layout, void* stream) {
  if (F <= 0 || L <= 0 || items <= 0) return 0;
  const long long* t = static_cast<const long long*>(lanes);
  const int err = launch_ring(nullptr, sf, sn, nullptr, 0, out, F, 0, B, fg,
                              dim3(items, 1), 0LL, threads, layout, t,
                              t + 4LL * L, L, stream);
  if (err != kNoVariant) return err;
  return hist_single_lanes_base(lanes, items, sf, sn, out, L, F, B, fg,
                                threads, layout, stream);
}

int hist_single_u16(const void* bins, long long sf, long long sn,
                    const void* w, long long ws, void* out, int F,
                    long long n, int B, int fg, int Bt, int cs, int peers,
                    int chunks, long long chunk_rows, int threads,
                    int layout, void* stream) {
  if (F <= 0 || n <= 0 || fg <= 0 || one_tile(B, Bt))
    return hist_single_u16_base(bins, sf, sn, w, ws, out, F, n, B, fg, Bt,
                                cs, peers, chunks, chunk_rows, threads,
                                layout, stream);
  const int fgc = fg * (cs / ((B + Bt - 1) / Bt));
  U16Launch C;
  const int err = u16_config(&C, F, B, fg, Bt, cs, chunks,
                             fgc > 0 ? (F + fgc - 1) / fgc : 0, threads,
                             stream);
  if (err != 0) return err;
  return launch_ship(C, bins, sf, sn, w, ws, out, F, n, B, fg, Bt, cs,
                     chunk_rows, nullptr, nullptr, 1);
}

int hist_single_lanes_u16(const void* lanes, int items, long long sf,
                          long long sn, void* out, int L, int F, int B,
                          int fg, int Bt, int cs, int peers, int threads,
                          int layout, void* stream) {
  if (F <= 0 || L <= 0 || items <= 0 || one_tile(B, Bt))
    return hist_single_lanes_u16_base(lanes, items, sf, sn, out, L, F, B, fg,
                                      Bt, cs, peers, threads, layout, stream);
  U16Launch C;
  const int err = u16_config(&C, F, B, fg, Bt, cs, (long long)items * cs, 1,
                             threads, stream);
  if (err != 0) return err;
  const long long* t = static_cast<const long long*>(lanes);
  return launch_ship(C, nullptr, sf, sn, nullptr, 0, out, F, 0, B, fg, Bt,
                     cs, 0LL, t, t + 4LL * L, L);
}

}  // extern "C"

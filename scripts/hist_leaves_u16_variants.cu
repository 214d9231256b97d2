// Variants of lightgbm_tpu_torch/csrc/hist_leaves_u16.cu's row-list
// histograms that the package does not build, kept so that
// scripts/torch_u16_lanes_sweep.py can time them beside the package's build
// (PERF.md section 6 has their times).  U16_VARIANT picks one:
//
//  1. a probe: every listed record and its codes loaded, nothing added
//     (the sums come out zero);
//  2. a probe: every listed record loaded, no code loaded and nothing
//     added;
//  3. the parent's adds: 64-bit atomicAdd through a generic address, q8 on
//     one (g << 32) + h word an entry (its sums come out wrong: the flush
//     reads the package's separate words; timed only), fx on int64 g and
//     h, the count a 32-bit atomicAdd: ATOM.E.ADD.64 with a
//     compare-and-swap fallback on the block's own window;
//  4. listed codes (q8): the partition's scatter also writes each listed
//     row's F codes in list order, feature-major ((F, N) a lane, codes[f
//     x N + place]), staged a feature at a time in shared memory and
//     written in runs, so that the histogram reads them coalesced beside
//     the records instead of gathering a 32-byte sector per 2-byte code.
//     The codes' buffer (L x F x N uint16) and the bins come from
//     set_listed_codes, called before the wrappers;
//  5. no warp merging: each lane adds its own codes (add_entry), the
//     lanes of a warp whose codes fall on one entry waiting on each other.
//
// All share the package's walk (list_block: the cluster's slot, its
// records, the zero fill, the barriers and the flush) and its adds
// (add_entry; 3 has its own); only the row's visitor differs.  The file
// includes the package's source with its histogram and partition entry
// points renamed (..._base) and exports them again; the scale-back is
// the package's own.  Build it as the sweep does:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DU16_VARIANT=1 -o libhl16_probe.so \
//        scripts/hist_leaves_u16_variants.cu

#define hist_leaves_fx_u16 hist_leaves_fx_u16_base
#define hist_leaves_q8_u16 hist_leaves_q8_u16_base
#define hist_leaves_fx_lanes_u16 hist_leaves_fx_lanes_u16_base
#define hist_leaves_q8_lanes_u16 hist_leaves_q8_lanes_u16_base
#define leaf_partition leaf_partition_base
#define leaf_partition_lanes leaf_partition_lanes_base
#include "../lightgbm_tpu_torch/csrc/hist_leaves_u16.cu"
#undef hist_leaves_fx_u16
#undef hist_leaves_q8_u16
#undef hist_leaves_fx_lanes_u16
#undef hist_leaves_q8_lanes_u16
#undef leaf_partition
#undef leaf_partition_lanes

#ifndef U16_VARIANT
#define U16_VARIANT 1
#endif

namespace {

constexpr int kVariant = U16_VARIANT;
static_assert(kVariant >= 1 && kVariant <= 5, "U16_VARIANT is 1 to 5");

// The package's code gather, kBatch codes of a live row at a time.
__device__ __forceinline__ void gather(int* v, int k, const Entry& e,
                                       bool live, const ListBlock& b) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    v[i] = live && k + i < b.nf
               ? (int)__ldg(b.col0 + (k + i) * b.N + e.row)
               : b.B;
}

// 5: each lane's own adds.
template <typename W, bool CL>
__device__ __forceinline__ void own_adds(const int* v, int k, const Entry& e,
                                         const ListBlock& b) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (v[i] >= b.B) continue;
    const int t = CL ? v[i] / b.Bt : 0;
    add_entry<W, CL>(b, (k + i) * b.Bt + v[i] - t * b.Bt, t, e.g, e.h,
                     e.n);
  }
}

// 3: the parent's adds.
template <typename W, bool CL>
__device__ __forceinline__ void parent_adds(const int* v, int k,
                                            const Entry& e,
                                            const ListBlock& b) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(
      smem + (sizeof(W) == 1 ? 8 : 16) * b.E);
  const unsigned long long gh =
      (unsigned long long)(((long long)e.g << 32) + e.h);
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (v[i] >= b.B) continue;
    const int t = CL ? v[i] / b.Bt : 0;
    const int x = (k + i) * b.Bt + v[i] - t * b.Bt;
    unsigned long long* a = acc;
    unsigned int* n = cnt;
    if (CL && t != b.tile) {
      a = cluster.map_shared_rank(acc, t);
      n = cluster.map_shared_rank(cnt, t);
    }
    asm("mov.b64 %0, %1;" : "=l"(a) : "l"(a));   // the state space hidden
    if constexpr (sizeof(W) == 1) {
      if (gh) atomicAdd(a + x, gh);
    } else {
      if (e.g) atomicAdd(a + x, (unsigned long long)e.g);
      if (e.h) atomicAdd(a + b.E + x, (unsigned long long)e.h);
    }
    if (e.n) atomicAdd(n + x, e.n);
  }
}

// The variants' visitor.  4: the codes of place p of lane z at
// col0 + z x F x N + k x N + p (the launch passes the listed codes as its
// bins).
template <typename W, bool CL>
struct VariantRow {
  int F = 0;
  unsigned int sink = 0u;
  __device__ __forceinline__ void operator()(const Entry& e, long long p,
                                             bool live, const ListBlock& b) {
    if constexpr (kVariant == 2) {
      sink += live ? (unsigned int)e.row : 0u;
      return;
    }
    const uint16_t* c0 = b.col0 + (long long)b.lane * F * b.N + p;
    for (int k = 0; k < b.nf; k += kBatch) {
      int v[kBatch];
      if constexpr (kVariant == 4) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          v[i] = live && k + i < b.nf ? (int)__ldg(c0 + (k + i) * b.N) : b.B;
      } else {
        gather(v, k, e, live, b);
      }
      if constexpr (kVariant == 1) {
#pragma unroll
        for (int i = 0; i < kBatch; ++i) sink += (unsigned int)v[i];
      } else if constexpr (kVariant == 3) {
        parent_adds<W, CL>(v, k, e, b);
      } else if constexpr (kVariant == 5) {
        own_adds<W, CL>(v, k, e, b);
      } else {
        add_codes<W, CL>(v, k, e, b);
      }
    }
  }
};

template <typename W, bool Owner, bool CL>
__global__ void __launch_bounds__(kThreads) variant_kernel(ListArgs a) {
  VariantRow<W, CL> row;
  row.F = a.F;
  list_block<W, Owner, CL>(a, row);
  if (row.sink == 0x9e3779b9u)   // never in practice: keeps the probes'
    static_cast<unsigned int*>(a.out)[threadIdx.x] = row.sink;   // loads
}

// 4: the listed codes' buffer and the bins it is written from.
const uint16_t* g_bins = nullptr;
uint16_t* g_codes = nullptr;
int g_F = 0;

// The package's part_scatter (q8), which also writes each listed row's
// codes at its place in the lane's (F, N) codes: a feature at a time, the
// tile's kept rows' codes staged at their stage places and written out in
// runs beside the records.
__global__ void __launch_bounds__(kPartThreads, 2)
listed_scatter(const int8_t* __restrict__ ch, const int8_t* __restrict__ w,
               long long N, int K, int S, long long block_rows,
               int* __restrict__ plan, long long* __restrict__ rec,
               const long long* __restrict__ lanes, int L, long long plan_ls,
               long long rec_ls, const uint16_t* __restrict__ bins, int F,
               uint16_t* __restrict__ codes) {
  using Tile = PartTile<int8_t>;
  constexpr int R = Tile::kSlots, TR = Tile::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  if (lanes) {
    const int z = blockIdx.y;
    ch = reinterpret_cast<const int8_t*>(lanes[z]);
    w = reinterpret_cast<const int8_t*>(lanes[L + z]);
    plan += z * plan_ls;
    rec += z * rec_ls;
    codes += (long long)z * F * N;
  }
  long long* stage = reinterpret_cast<long long*>(smem);
  int* sdst = reinterpret_cast<int*>(smem + TR * Tile::kRecBytes);
  int* wcnt = sdst + TR;
  int* small = wcnt + kPartWarps * kMaxK;
  const PartTables t{small, small + (kMaxK + 8), small + 2 * (kMaxK + 8),
                     small + 3 * (kMaxK + 8), small + 4 * (kMaxK + 8),
                     small + 5 * (kMaxK + 8), small + 6 * (kMaxK + 8)};
  int8_t* ch_s = reinterpret_cast<int8_t*>(small + kSmallInts);
  int8_t* w_s = ch_s + TR;
  uint16_t* cst = reinterpret_cast<uint16_t*>(smem + Tile::kSmem);
  int* offsets = plan;
  int* slots = offsets + K + 1;
  int* table = slots + K;
  const int* counts = table + S + K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  block_places(counts, K, gridDim.x, t);
  if (blockIdx.x == 0) write_plan(K, S, t, offsets, slots, table);

  long long r0, r1;
  block_span(N, block_rows, &r0, &r1);
  const bool loader = threadIdx.x < TR / 16;
  const bool ch_aligned = (reinterpret_cast<uintptr_t>(ch) & 15) == 0;
  const bool w_aligned =
      ((reinterpret_cast<uintptr_t>(w) | (uintptr_t)N) & 15) == 0;
  int4 nch = {0, 0, 0, 0}, nw[3] = {nch, nch, nch};
  auto fetch = [&](long long t0) {
    const long long r = t0 + 16LL * threadIdx.x;
    nch = load16(ch, r, r1, ch_aligned, -1);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      nw[q] = load16(w + q * N, r, r1, w_aligned, 0);
  };
  if (loader && r0 < r1) fetch(r0);
  const unsigned int below = lanes_below();
  const int xb = warp * 32 * R + lane;

  for (long long t0 = r0; t0 < r1; t0 += TR) {
    if (loader) {
      reinterpret_cast<int4*>(ch_s)[threadIdx.x] = nch;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        reinterpret_cast<int4*>(w_s + q * TR)[threadIdx.x] = nw[q];
    }
    for (int c = lane; c < kMaxK; c += 32) wcnt[warp * kMaxK + c] = 0;
    __syncthreads();
    if (loader && t0 + TR < r1) fetch(t0 + TR);

    int key[R], rank[R], pos[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = ch_s[xb + i * 32];
      key[i] = (c >= 0 && c < K) ? c : -1;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
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
    __syncthreads();

    if (warp == 0) {
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
    __syncthreads();

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = key[i];
      pos[i] = -1;
      if (c < 0) continue;
      const int x = xb + i * 32;
      pos[i] = t.tstart[c] + wcnt[warp * kMaxK + c] + rank[i];
      stage[pos[i]] = (t0 + x) |
                      ((long long)(unsigned char)w_s[x] << 32) |
                      ((long long)(unsigned char)w_s[TR + x] << 40) |
                      ((long long)(unsigned char)w_s[2 * TR + x] << 48);
      sdst[pos[i]] = pos[i] + t.shift[c];
    }
    __syncthreads();
    const int kept = t.tstart[K];
    for (int i = threadIdx.x; i < kept; i += kPartThreads)
      rec[sdst[i]] = stage[i];
    for (int f = 0; f < F; ++f) {
      const uint16_t* col = bins + (long long)f * N + t0;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (pos[i] >= 0) cst[pos[i]] = __ldg(col + xb + i * 32);
      __syncthreads();
      uint16_t* out = codes + (long long)f * N;
      for (int i = threadIdx.x; i < kept; i += kPartThreads)
        out[sdst[i]] = cst[i];
      __syncthreads();
    }
  }
}

int listed_partition(const void* ch, const void* w, long long N, int K, int P,
                     int S, void* rec, void* plan, void* stream,
                     const long long* lanes = nullptr, int L = 1) {
  if (N <= 0 || K <= 0 || L <= 0) return 0;
  if (K > kMaxK || P <= 0 || S < 0 || N > 0x7fffffffLL || L > 65535 ||
      (long long)K * P * sizeof(int) > 232448 || g_codes == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plan_ls = lanes ? plan_ints(K, P, S) : 0;
  const long long rec_ls = lanes ? N : 0;
  const long long block_rows = part_block_rows(N, P);
  const int smem = PartTile<int8_t>::kSmem + PartTile<int8_t>::kRows * 2;
  const int count_smem = K * kCountThreads * (int)sizeof(int);
  int err = prepare(listed_scatter, smem);
  if (err == 0) err = prepare(part_count, count_smem);
  if (err != 0) return err;
  const int8_t* c8 = static_cast<const int8_t*>(ch);
  int* p = static_cast<int*>(plan);
  const dim3 grid(P, L);
  part_count<<<grid, kCountThreads, count_smem, s>>>(c8, N, K, S, block_rows,
                                                     p, lanes, plan_ls);
  listed_scatter<<<grid, kPartThreads, smem, s>>>(
      c8, static_cast<const int8_t*>(w), N, K, S, block_rows, p,
      static_cast<long long*>(rec), lanes, L, plan_ls, rec_ls, g_bins, g_F,
      g_codes);
  return (int)cudaGetLastError();
}

template <typename W, bool Owner>
int variant(const void* bins, const void* rec, const void* plan, void* out,
            const void* scale, int L, int F, long long N, int B, int K, int fg,
            int Bt, int S, int P, int order, void* stream) {
  if (kVariant == 4 && sizeof(W) == 1) bins = g_codes;   // listed codes
  return hist_lanes<W, Owner>(bins, rec, plan, out, scale, L, F, N, B, K,
                              fg, Bt, S, P, order, stream,
                              variant_kernel<W, Owner, false>,
                              variant_kernel<W, Owner, true>);
}

}  // namespace

extern "C" {

// 4: the bins the partition reads codes from and the (L, F, N) uint16
// buffer it writes them to (F features, N rows a lane).
int set_listed_codes(const void* bins, int F, void* codes) {
  g_bins = static_cast<const uint16_t*>(bins);
  g_F = F;
  g_codes = static_cast<uint16_t*>(codes);
  return 0;
}

int leaf_partition(const void* ch, const void* w, int wbytes, long long N,
                   int K, int P, int S, void* rec, void* plan, void* stream) {
  if (kVariant == 4 && wbytes == 1)
    return listed_partition(ch, w, N, K, P, S, rec, plan, stream);
  return leaf_partition_base(ch, w, wbytes, N, K, P, S, rec, plan, stream);
}

int leaf_partition_lanes(const void* lanes, int wbytes, long long N, int K,
                         int P, int S, void* rec, void* plan, int L,
                         void* stream) {
  if (kVariant == 4 && wbytes == 1)
    return listed_partition(nullptr, nullptr, N, K, P, S, rec, plan, stream,
                            static_cast<const long long*>(lanes), L);
  return leaf_partition_lanes_base(lanes, wbytes, N, K, P, S, rec, plan, L,
                                   stream);
}

int hist_leaves_fx_u16(const void* bins, const void* rec, const void* plan,
                       void* out, const void* scale, int F, long long N,
                       int B, int K, int fg, int Bt, int S, void* stream) {
  return scale ? variant<long long, true>(bins, rec, plan, out, scale, 1, F,
                                          N, B, K, fg, Bt, S, 0, kLaneMajor,
                                          stream)
               : variant<long long, false>(bins, rec, plan, out, nullptr, 1,
                                           F, N, B, K, fg, Bt, S, 0,
                                           kLaneMajor, stream);
}

int hist_leaves_q8_u16(const void* bins, const void* rec, const void* plan,
                       void* out, int F, long long N, int B, int K, int fg,
                       int Bt, int S, void* stream) {
  return variant<int8_t, false>(bins, rec, plan, out, nullptr, 1, F, N, B,
                                K, fg, Bt, S, 0, kLaneMajor, stream);
}

int hist_leaves_fx_lanes_u16(const void* bins, const void* rec,
                             const void* plan, void* out, const void* scale,
                             int L, int F, long long N, int B, int K, int fg,
                             int Bt, int S, int P, int order, void* stream) {
  return scale ? variant<long long, true>(bins, rec, plan, out, scale, L, F,
                                          N, B, K, fg, Bt, S, P, order,
                                          stream)
               : variant<long long, false>(bins, rec, plan, out, nullptr, L,
                                           F, N, B, K, fg, Bt, S, P, order,
                                           stream);
}

int hist_leaves_q8_lanes_u16(const void* bins, const void* rec,
                             const void* plan, void* out, int L, int F,
                             long long N, int B, int K, int fg, int Bt, int S,
                             int P, int order, void* stream) {
  return variant<int8_t, false>(bins, rec, plan, out, nullptr, L, F, N, B,
                                K, fg, Bt, S, P, order, stream);
}

}  // extern "C"

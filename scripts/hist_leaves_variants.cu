// Variants of lightgbm_tpu_torch/csrc/hist_leaves.cu that the package
// does not build, kept so that scripts/torch_leaf_lanes_sweep.py can time
// them beside the package's build (PERF.md section 6 has their times).
// LEAF_VARIANT picks one:
//
//  1. the other add form: 64-bit words through a generic address (q8:
//     one (g << 32) + h word an entry, fx: int64 g and h), ATOM.E.ADD.64
//     on the shared window with a compare-and-swap fallback
//     (ATOMS.CAST.SPIN.64) behind the predicate the atomic sets.  Exact:
//     a q8 block's sums stay within 2^31 (Q8_MAX_BLOCK_ROWS), so the low
//     word holds sum h and the carries into the high word are undone at
//     the flush.
//  2. a probe: every row queued and its weights and bins loaded, but
//     nothing added (the sums come out zero).
//  3. a probe: every row queued, nothing loaded or added.
//
// The file includes the package's source with its six histogram entry
// points renamed (..._base) and exports them again, each launching the
// variant's kernel, which shares the package's block skip (block_live),
// channel scan (scan_rows) and row loads; leaf_lanes_live is the
// package's own.  Build it as the sweep does:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -DLEAF_VARIANT=1 -o libhl_other.so \
//        scripts/hist_leaves_variants.cu

#define hist_leaves_q8 hist_leaves_q8_base
#define hist_leaves_fx hist_leaves_fx_base
#define hist_leaves_q8_p4 hist_leaves_q8_p4_base
#define hist_leaves_fx_p4 hist_leaves_fx_p4_base
#define hist_leaves_q8_lanes hist_leaves_q8_lanes_base
#define hist_leaves_fx_lanes hist_leaves_fx_lanes_base
#include "../lightgbm_tpu_torch/csrc/hist_leaves.cu"
#undef hist_leaves_q8
#undef hist_leaves_fx
#undef hist_leaves_q8_p4
#undef hist_leaves_fx_p4
#undef hist_leaves_q8_lanes
#undef hist_leaves_fx_lanes

#ifndef LEAF_VARIANT
#define LEAF_VARIANT 1
#endif

namespace {

constexpr int kVariant = LEAF_VARIANT;
static_assert(kVariant >= 1 && kVariant <= 3, "LEAF_VARIANT is 1, 2 or 3");

// A 64-bit value through a generic address: one ATOM.E.ADD.64 on the
// shared window, whose SASS keeps a compare-and-swap fallback behind a
// predicate the atomic sets.
__device__ __forceinline__ void add64_generic(unsigned long long* p,
                                              unsigned long long x) {
  unsigned long long* q;
  asm("mov.b64 %0, %1;" : "=l"(q) : "l"(p));   // the state space hidden
  atomicAdd(q, x);
}

// The package's add_row with the variant's adds: variant 1 the generic
// 64-bit ones, variant 2 none (a sink keeps the loads).
template <typename W, bool PACKED>
__device__ __forceinline__ void variant_row(
    unsigned char* smem, const Hist& H, const uint8_t* __restrict__ bins,
    const W* __restrict__ w, long long fstride, long long N, int B, int nf,
    unsigned int q, long long r0, unsigned long long& sink) {
  const long long row = r0 + (q >> kChBits);
  const int base = (int)(q & ((1u << kChBits) - 1)) * nf * B;
  const long long g = __ldg(w + row);
  const long long h = __ldg(w + N + row);
  unsigned int n;
  if constexpr (sizeof(W) == 1)
    n = (unsigned int)(int)__ldg(w + 2 * N + row);
  else
    n = (unsigned int)__ldg(w + 2 * N + row);
  unsigned long long* a = reinterpret_cast<unsigned long long*>(smem);
  for (int k = 0; k < nf; k += 4) {
    int e[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b =
          k + i < nf ? bin_of<PACKED>(bins + (k + i) * fstride, row) : B;
      ok[i] = b < B;
      e[i] = base + (k + i) * B + b;
    }
    if ((g | h) == 0 && n == 0u) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      if constexpr (kVariant == 2) {
        sink += (unsigned long long)e[i] ^ (unsigned long long)(g + h + n);
        continue;
      }
      if constexpr (sizeof(W) == 1) {
        const unsigned long long gh = (unsigned long long)((g << 32) + h);
        if (gh) add64_generic(a + e[i], gh);
      } else {
        if (g) add64_generic(a + e[i], (unsigned long long)g);
        if (h) add64_generic(a + H.Ea + e[i], (unsigned long long)h);
      }
      if (n) red_sh(H.cnt + 4u * e[i], n);
    }
  }
}

// hist_leaves_kernel with the variant's adds; arguments and grid as there.
template <typename W, bool PACKED>
__global__ void __launch_bounds__(kThreads)
hist_leaves_variant_kernel(const uint8_t* __restrict__ bins,
                           const W* __restrict__ w,
                           const int8_t* __restrict__ ch,
                           void* __restrict__ out, int F, long long N, int B,
                           int K, int cg, int fg, long long chunk_rows,
                           int vec, const long long* __restrict__ lanes,
                           int L, const int* __restrict__ live) {
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
  unsigned int* words = reinterpret_cast<unsigned int*>(smem);
  for (int i = threadIdx.x; i < Ea * (Q8 ? 2 : 4); i += blockDim.x)
    words[i] = 0u;
  for (int i = threadIdx.x; i < E; i += blockDim.x) cnt[i] = 0u;
  __syncthreads();

  const long long fstride = PACKED ? N / 2 : N;
  const uint8_t* col0 = bins + (long long)k.f0 * fstride;
  unsigned long long sink = 0ULL;   // the probes'
  if constexpr (kVariant == 3) {
    scan_rows(ch, k, vec != 0, queue, [&](unsigned int q) { sink += q; });
  } else {
    scan_rows(ch, k, vec != 0, queue, [&](unsigned int q) {
      variant_row<W, PACKED>(smem, H, col0, w, fstride, N, B, k.nf, q, k.r0,
                             sink);
    });
  }
  if (kVariant != 1 && sink == 0x9e3779b97f4a7c15ULL) cnt[0] = 1u;
  __syncthreads();

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const long long o = out_of(k, F, B, i);
    const unsigned int n = cnt[i];
    if constexpr (Q8) {
      int gs, hs;
      if constexpr (kVariant == 1) {   // (g << 32) + h, its carries undone
        const unsigned long long a =
            reinterpret_cast<const unsigned long long*>(smem)[i];
        hs = (int)(unsigned int)(a & 0xffffffffULL);
        gs = (int)((long long)(a - (unsigned long long)(long long)hs) >> 32);
      } else {
        gs = reinterpret_cast<const int*>(smem)[i];
        hs = reinterpret_cast<const int*>(smem)[Ea + i];
      }
      int* o32 = static_cast<int*>(out) + o;
      if (gs) red_global(o32, gs);
      if (hs) red_global(o32 + 1, hs);
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

template <typename W, bool PACKED>
int launch_variant(const void* bins, const void* w, const void* ch,
                   void* out, int F, long long N, int B, int K, int cg,
                   int fg, int chunks, long long chunk_rows, int vec,
                   void* stream, const long long* lanes = nullptr,
                   int L = 1, const int* live = nullptr) {
  if (F <= 0 || N <= 0 || K <= 0 || L <= 0) return 0;
  if (L > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  if (cg >= (1 << kChBits) || chunk_rows > (1LL << (32 - kChBits)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cg * fg * B * (sizeof(W) == 1 ? 12 : 20) +
                      (size_t)(kThreads / 32) * kQueue * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hist_leaves_variant_kernel<W, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int combos = ((K + cg - 1) / cg) * ((F + fg - 1) / fg);
  dim3 grid(combos, L, chunks);
  hist_leaves_variant_kernel<W, PACKED>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(bins), static_cast<const W*>(w),
          static_cast<const int8_t*>(ch), out, F, N, B, K, cg, fg,
          chunk_rows, vec, lanes, L, live);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The package's entry points, arguments as there.

int hist_leaves_q8(const void* bins, const void* wch, const void* ch,
                   void* out, int F, long long N, int B, int K, int cg,
                   int fg, int chunks, long long chunk_rows, int vec,
                   void* stream) {
  return launch_variant<int8_t, false>(bins, wch, ch, out, F, N, B, K, cg,
                                       fg, chunks, chunk_rows, vec, stream);
}

int hist_leaves_fx(const void* bins, const void* w, const void* ch,
                   void* out, int F, long long N, int B, int K, int cg,
                   int fg, int chunks, long long chunk_rows, int vec,
                   void* stream) {
  return launch_variant<long long, false>(bins, w, ch, out, F, N, B, K, cg,
                                          fg, chunks, chunk_rows, vec,
                                          stream);
}

int hist_leaves_q8_p4(const void* bins, const void* wch, const void* ch,
                      void* out, int F, long long N, int B, int K, int cg,
                      int fg, int chunks, long long chunk_rows, int vec,
                      void* stream) {
  return launch_variant<int8_t, true>(bins, wch, ch, out, F, N, B, K, cg,
                                      fg, chunks, chunk_rows, vec, stream);
}

int hist_leaves_fx_p4(const void* bins, const void* w, const void* ch,
                      void* out, int F, long long N, int B, int K, int cg,
                      int fg, int chunks, long long chunk_rows, int vec,
                      void* stream) {
  return launch_variant<long long, true>(bins, w, ch, out, F, N, B, K, cg,
                                         fg, chunks, chunk_rows, vec,
                                         stream);
}

int hist_leaves_q8_lanes(const void* bins, const void* lanes,
                         const void* live, void* out, int L, int F,
                         long long N, int B, int K, int cg, int fg,
                         int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  const int* v = static_cast<const int*>(live);
  return packed ? launch_variant<int8_t, true>(bins, nullptr, nullptr, out,
                                               F, N, B, K, cg, fg, chunks,
                                               chunk_rows, vec, stream, t, L,
                                               v)
                : launch_variant<int8_t, false>(bins, nullptr, nullptr, out,
                                                F, N, B, K, cg, fg, chunks,
                                                chunk_rows, vec, stream, t,
                                                L, v);
}

int hist_leaves_fx_lanes(const void* bins, const void* lanes,
                         const void* live, void* out, int L, int F,
                         long long N, int B, int K, int cg, int fg,
                         int chunks, long long chunk_rows, int vec,
                         int packed, void* stream) {
  const long long* t = static_cast<const long long*>(lanes);
  const int* v = static_cast<const int*>(live);
  return packed ? launch_variant<long long, true>(bins, nullptr, nullptr,
                                                  out, F, N, B, K, cg, fg,
                                                  chunks, chunk_rows, vec,
                                                  stream, t, L, v)
                : launch_variant<long long, false>(bins, nullptr, nullptr,
                                                   out, F, N, B, K, cg, fg,
                                                   chunks, chunk_rows, vec,
                                                   stream, t, L, v);
}

}  // extern "C"

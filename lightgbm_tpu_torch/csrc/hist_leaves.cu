// Leaf-channel batched histograms for the wave grower, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py:
//   * build_histogram_pallas_leaves_q8 (_hist_leaves_q8_kernel, and the DMA
//     form _leaves_dma_common with _make_w128_q8): 42 leaf channels of
//     (sum g_q, sum h_q, count) from int8 quantized weights, int32 sums;
//   * build_histogram_pallas_leaves (_hist_leaves_kernel, and the DMA form
//     with _make_w128_bf16): 25 leaf channels of (sum g*mask, sum h*mask,
//     count);
//   * the nibble-packed forms of both (_leaves_dma_common with
//     packed=True, behind bins_packed=True): bins arrive as (F, N/2) bytes,
//     row 2j in the low nibble of byte j and row 2j+1 in the high nibble
//     (ops/histogram.py pack_bins4), when every feature fits 16 bins.
// The TPU kernels turn the scatter-add into a one-hot MXU contraction
// because the TPU has no fast atomics.  Hopper has fast shared-memory
// atomics, so this is the scatter-add itself (the reference's own CUDA
// learner, histogram_16_64_256.cu, has the same shape).
//
// Design.  One block owns one feature and one chunk of the feature's bin
// bytes and keeps a privatized shared-memory histogram of K channels x B
// bins x 3 values.  Each thread walks bytes of the chunk: one row per byte
// in the uint8 form, the two rows of the byte in the packed form (so each
// byte of bins is loaded once).  A row whose channel is outside [0, K) (-1
// marks rows in no batched leaf) or whose bin is outside [0, B) is
// skipped; the others add their three weights with shared atomics.  The
// block then flushes its non-zero entries to the global (K, F, B, 3)
// result with global atomics.  The grid puts the feature index fastest, so
// the blocks that run at the same time share row chunks and the chunk's
// weights and channels are read from L2 rather than from device memory
// once per feature.
//
// Both weight types accumulate INTEGERS, so the result does not depend
// on the order in which atomics land and is bit-identical from run to run:
//   * q8: int8 weights -> int32 sums (as the reference, exact);
//   * the exact (f32) histogram: the wrapper converts g*mask and h*mask to
//     64-bit fixed point with a per-tree power-of-two scale (see
//     ops/histogram.py pack_weights), the kernel sums int64, and the
//     wrapper scales the sums back to f32.  Shared-memory f32 atomics
//     would make the sums depend on thread timing; fixed point removes
//     that and is closer to the exact sum than any f32 summation order.
//
// What bounds it on the H100.  Each row is read as its channel byte and
// weights (3 B for q8, 24 B for fixed point) plus 1 bin byte per feature
// (half a byte when packed); at 10.5M rows x 28 features that is ~0.3 GB
// for q8 and ~0.55 GB for the fixed-point form, i.e. 0.1-0.2 ms at
// 3.35 TB/s.  This first version is limited instead by shared-atomic
// throughput (one atomic per row, feature and value) and by the per-block
// flush; the byte loads are 1-byte and only partly coalesced.  Packing
// halves the bin bytes but not the atomics, so it is not expected to be
// faster here.  Vectorised loads, several features per block and a
// warp-aggregated flush are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
struct AccOf;
template <>
struct AccOf<int8_t> { typedef int acc_t; };
template <>
struct AccOf<long long> { typedef unsigned long long acc_t; };

__device__ __forceinline__ void atomic_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(unsigned long long* p,
                                           unsigned long long v) {
  atomicAdd(p, v);
}

// row r of channel c (in [0, K)) with bin b: add its three weights into the
// block's (K, B, 3) histogram; bins outside [0, B) are ignored, as in plain
template <typename W, typename A>
__device__ __forceinline__ void add_row(A* hist, const W* __restrict__ w,
                                        long long N, long long r, int c,
                                        int b, int B) {
  if (b >= B) return;
  A* h = hist + (c * B + b) * 3;
  const W g = w[r], hh = w[N + r], cnt = w[2 * N + r];
  if (g != 0) atomic_add(h, (A)g);
  if (hh != 0) atomic_add(h + 1, (A)hh);
  if (cnt != 0) atomic_add(h + 2, (A)cnt);
}

// bins: (F, N) uint8 feature-major, or (F, N/2) nibble-packed bytes when
// PACKED.  w: (wrows, N) weights, rows 0..2 are the three channels.  ch:
// (N,) int8 leaf channel.  out: (K, F, B, 3).  chunk: bytes per block.
template <typename W, bool PACKED>
__global__ void hist_leaves_kernel(const uint8_t* __restrict__ bins,
                                   const W* __restrict__ w,
                                   const int8_t* __restrict__ ch,
                                   typename AccOf<W>::acc_t* __restrict__ out,
                                   int F, int N, int B, int K, int chunk) {
  typedef typename AccOf<W>::acc_t acc_t;
  extern __shared__ unsigned char smem_raw[];
  acc_t* hist = reinterpret_cast<acc_t*>(smem_raw);
  const int f = blockIdx.x;
  const long long bytes = PACKED ? N / 2 : N;
  const long long j0 = (long long)blockIdx.y * chunk;
  long long j1 = j0 + chunk;
  if (j1 > bytes) j1 = bytes;
  const int entries = K * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const uint8_t* col = bins + (long long)f * bytes;
  for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    if (PACKED) {
      const long long r = 2 * j;
      const int c0 = ch[r], c1 = ch[r + 1];
      const bool in0 = c0 >= 0 && c0 < K, in1 = c1 >= 0 && c1 < K;
      if (!(in0 || in1)) continue;
      const int v = col[j];
      if (in0) add_row(hist, w, N, r, c0, v & 15, B);
      if (in1) add_row(hist, w, N, r + 1, c1, v >> 4, B);
    } else {
      const int c = ch[j];
      if (c < 0 || c >= K) continue;
      add_row(hist, w, N, j, c, col[j], B);
    }
  }
  __syncthreads();

  // flush: entry (c, b, k) -> out[((c * F + f) * B + b) * 3 + k]
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const acc_t v = hist[i];
    if (v == 0) continue;
    const int k = i % 3;
    const int cb = i / 3;
    const int b = cb % B;
    const int c = cb / B;
    atomic_add(out + (((long long)c * F + f) * B + b) * 3 + k, v);
  }
}

template <typename W, bool PACKED>
int launch(const void* bins, const void* w, const void* ch, void* out, int F,
           int N, int B, int K, int chunk, int threads, void* stream) {
  typedef typename AccOf<W>::acc_t acc_t;
  const size_t smem = (size_t)K * B * 3 * sizeof(acc_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_leaves_kernel<W, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = PACKED ? N / 2 : N;
  dim3 grid(F, (unsigned)((bytes + chunk - 1) / chunk));
  hist_leaves_kernel<W, PACKED>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(bins), static_cast<const W*>(w),
          static_cast<const int8_t*>(ch), static_cast<acc_t*>(out), F, N, B,
          K, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 42-channel quantized histogram: wch (8, N) int8 [g_q, h_q, count, 0...],
// out (K, F, B, 3) int32, zero-filled by the caller.  bins (F, N) uint8;
// chunk in rows.
int hist_leaves_q8(const void* bins, const void* wch, const void* ch,
                   void* out, int F, int N, int B, int K, int chunk,
                   int threads, void* stream) {
  return launch<int8_t, false>(bins, wch, ch, out, F, N, B, K, chunk,
                               threads, stream);
}

// 25-channel exact histogram on 64-bit fixed-point weights: w (3, N) int64,
// out (K, F, B, 3) int64, zero-filled by the caller.
int hist_leaves_fx(const void* bins, const void* w, const void* ch,
                   void* out, int F, int N, int B, int K, int chunk,
                   int threads, void* stream) {
  return launch<long long, false>(bins, w, ch, out, F, N, B, K, chunk,
                                  threads, stream);
}

// The packed forms: bins (F, N/2) nibble-packed bytes, N even, B <= 16;
// chunk in bytes.  Everything else as above.
int hist_leaves_q8_p4(const void* bins, const void* wch, const void* ch,
                      void* out, int F, int N, int B, int K, int chunk,
                      int threads, void* stream) {
  return launch<int8_t, true>(bins, wch, ch, out, F, N, B, K, chunk, threads,
                              stream);
}

int hist_leaves_fx_p4(const void* bins, const void* w, const void* ch,
                      void* out, int F, int N, int B, int K, int chunk,
                      int threads, void* stream) {
  return launch<long long, true>(bins, w, ch, out, F, N, B, K, chunk,
                                 threads, stream);
}

}  // extern "C"

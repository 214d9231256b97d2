// Leaf-channel batched histograms for the wave grower, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py:
//   * build_histogram_pallas_leaves_q8 (_hist_leaves_q8_kernel, and the DMA
//     form _leaves_dma_common with _make_w128_q8): 42 leaf channels of
//     (sum g_q, sum h_q, count) from int8 quantized weights, int32 sums;
//   * build_histogram_pallas_leaves (_hist_leaves_kernel, and the DMA form
//     with _make_w128_bf16): 25 leaf channels of (sum g*mask, sum h*mask,
//     count).
// The TPU kernels turn the scatter-add into a one-hot MXU contraction
// because the TPU has no fast atomics.  Hopper has fast shared-memory
// atomics, so this is the scatter-add itself (the reference's own CUDA
// learner, histogram_16_64_256.cu, has the same shape).
//
// Design.  One block owns one feature and one chunk of rows and keeps a
// privatized shared-memory histogram of K channels x B bins x 3 values.
// Each thread walks rows of the chunk, skips rows whose channel is outside
// [0, K) (-1 marks rows in no batched leaf) and bins outside [0, B), and
// adds its row's three weights with shared atomics.  The block then flushes its non-zero
// entries to the global (K, F, B, 3) result with global atomics.  The grid
// puts the feature index fastest, so the blocks that run at the same time
// share row chunks and the chunk's weights and channels are read from L2
// rather than from device memory once per feature.
//
// Both instantiations accumulate INTEGERS, so the result does not depend
// on the order in which atomics land and is bit-identical from run to run:
//   * q8: int8 weights -> int32 sums (as the reference, exact);
//   * the exact (f32) histogram: the wrapper converts g*mask and h*mask to
//     64-bit fixed point with a per-tree power-of-two scale (see
//     ops/histogram.py pack_weights), the kernel sums int64, and the
//     wrapper scales the sums back to f32.  Shared-memory f32 atomics
//     would make the sums depend on thread timing; fixed point removes
//     that and is closer to the exact sum than any f32 summation order.
//
// What bounds it on the H100.  Each row is read as 1 bin byte per feature
// plus its channel byte and weights (3 B for q8, 24 B for fixed point);
// at 10.5M rows x 28 features that is ~0.3 GB for q8 and ~0.55 GB for the
// fixed-point form, i.e. 0.1-0.2 ms at 3.35 TB/s.  This first version is
// limited instead by shared-atomic throughput (one atomic per row, feature
// and value) and by the per-block flush; the byte loads are 1-byte and
// only partly coalesced.  Vectorised loads, several features per block and
// a warp-aggregated flush are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
struct AccOf;
template <>
struct AccOf<int8_t> { typedef int acc_t; };
template <>
struct AccOf<long long> { typedef unsigned long long acc_t; };

__device__ __forceinline__ void shared_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void shared_add(unsigned long long* p,
                                           unsigned long long v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void global_add(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void global_add(unsigned long long* p,
                                           unsigned long long v) {
  atomicAdd(p, v);
}

// bins: (F, N) uint8 feature-major.  w: (wrows, N) weights, rows 0..2 are
// the three channels.  ch: (N,) int8 leaf channel.  out: (K, F, B, 3).
template <typename W>
__global__ void hist_leaves_kernel(const uint8_t* __restrict__ bins,
                                   const W* __restrict__ w,
                                   const int8_t* __restrict__ ch,
                                   typename AccOf<W>::acc_t* __restrict__ out,
                                   int F, int N, int B, int K, int chunk) {
  typedef typename AccOf<W>::acc_t acc_t;
  extern __shared__ unsigned char smem_raw[];
  acc_t* hist = reinterpret_cast<acc_t*>(smem_raw);
  const int f = blockIdx.x;
  const long long r0 = (long long)blockIdx.y * chunk;
  long long r1 = r0 + chunk;
  if (r1 > N) r1 = N;
  const int entries = K * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const uint8_t* col = bins + (long long)f * N;
  const W* w0 = w;
  const W* w1 = w + N;
  const W* w2 = w + 2LL * N;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int c = ch[r];
    if (c < 0 || c >= K) continue;
    const int b = col[r];
    if (b >= B) continue;  // outside the histogram: ignored, as in plain
    acc_t* h = hist + (c * B + b) * 3;
    const W g = w0[r], hh = w1[r], cnt = w2[r];
    if (g != 0) shared_add(h, (acc_t)g);
    if (hh != 0) shared_add(h + 1, (acc_t)hh);
    if (cnt != 0) shared_add(h + 2, (acc_t)cnt);
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
    global_add(out + (((long long)c * F + f) * B + b) * 3 + k, v);
  }
}

template <typename W>
int launch(const uint8_t* bins, const W* w, const int8_t* ch,
           typename AccOf<W>::acc_t* out, int F, int N, int B, int K,
           int chunk, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)K * B * 3 * sizeof(typename AccOf<W>::acc_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_leaves_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(F, (N + chunk - 1) / chunk);
  hist_leaves_kernel<W><<<grid, threads, smem, stream>>>(bins, w, ch, out, F,
                                                         N, B, K, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 42-channel quantized histogram: wch (8, N) int8 [g_q, h_q, count, 0...],
// out (K, F, B, 3) int32, zero-filled by the caller.
int hist_leaves_q8(const void* bins, const void* wch, const void* ch,
                   void* out, int F, int N, int B, int K, int chunk,
                   int threads, void* stream) {
  return launch<int8_t>(static_cast<const uint8_t*>(bins),
                        static_cast<const int8_t*>(wch),
                        static_cast<const int8_t*>(ch),
                        static_cast<int*>(out), F, N, B, K, chunk, threads,
                        static_cast<cudaStream_t>(stream));
}

// 25-channel exact histogram on 64-bit fixed-point weights: w (3, N) int64,
// out (K, F, B, 3) int64, zero-filled by the caller.
int hist_leaves_fx(const void* bins, const void* w, const void* ch,
                   void* out, int F, int N, int B, int K, int chunk,
                   int threads, void* stream) {
  return launch<long long>(static_cast<const uint8_t*>(bins),
                           static_cast<const long long*>(w),
                           static_cast<const int8_t*>(ch),
                           static_cast<unsigned long long*>(out), F, N, B, K,
                           chunk, threads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

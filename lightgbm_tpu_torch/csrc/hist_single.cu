// Single-leaf histogram for the partitioned grower and quantized leaf
// renewal, hand-written for Hopper (sm_90a).
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
// per tree (ops/histogram.py pack_weights), as in hist_leaves.cu, so
// the sums are integers: the result does not depend on the order in which
// atomics land, equals the plain version bit for bit, and a parent minus
// its smaller child is exact.
//
// Layout.  The bins are an (F, n) view with ANY two strides: the
// partitioned grower passes P[s:e, :F].T of its row-major, leaf-contiguous
// packed rows (feature stride 1, row stride = the row width), quantized
// leaf renewal a (1, N) row->leaf column; both are read in place, with no
// transpose copy.  The weights are a (3, n) int64 view whose rows may be
// strided (a slice of the tree's (3, N) weights).
//
// Design.  A single leaf needs only B x 3 x 8 bytes of shared memory per
// feature (6 KB at B=256), so one block keeps a privatized histogram of a
// GROUP of up to fg features (all 28 of the Higgs shape: 172 KB at B=256)
// and walks one chunk of rows: each thread loads a row's three weights
// once, skips the row if they are all zero (out of the bag or the leaf),
// and adds them into every feature's bin of that row.  A row's bin bytes
// are therefore read once, not once per feature as in hist_leaves.cu.
// The block then flushes its non-zero entries into the global (F, B, 3)
// int64 result with global atomics.  grid = (row chunks, feature groups).
//
// What bounds it on the H100: bytes.  Per row of the segment it reads F
// bin bytes and 24 bytes of weights; the smaller child of a 10.5M-row
// root averages a few million rows, ~0.1 GB, 30 us at 3.35 TB/s.  This
// first version is limited instead by the shared 64-bit atomics (three
// per row and feature) and by single-byte loads; vector loads, warp
// aggregation of equal bins and fewer, larger row chunks are later work.
//
// The packed form (hist_single_p4) takes the autotuner's layout: a
// contiguous feature-major (F, N/2) matrix of bytes, row 2j in the low
// nibble of byte j and row 2j+1 in the high nibble (ops/histogram.py
// pack_bins4), B <= 16, and contiguous (3, N) weights.  One thread takes
// one byte index: it loads the weights of both rows once, skips the pair
// if all six are zero, and for every feature of the group loads the byte
// once and adds each row into its nibble's bin.  At B <= 16 the whole
// group's histogram is at most 10.5 KB of shared memory, so every feature
// fits one block.  Half the bin bytes of the uint8 form, the same atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hist_single_kernel(const uint8_t* __restrict__ bins,
                                   long long sf, long long sn,
                                   const long long* __restrict__ w,
                                   long long ws,
                                   unsigned long long* __restrict__ out,
                                   int F, int n, int B, int fg, int chunk) {
  extern __shared__ unsigned long long hist[];
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = min((long long)n, r0 + chunk);
  const int entries = nf * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) hist[i] = 0ULL;
  __syncthreads();

  const long long* w0 = w;
  const long long* w1 = w + ws;
  const long long* w2 = w + 2 * ws;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const long long g = w0[r], h = w1[r], c = w2[r];
    if ((g | h | c) == 0) continue;  // contributes nothing
    const uint8_t* row = bins + r * sn + (long long)f0 * sf;
    for (int j = 0; j < nf; ++j) {
      const int b = row[j * sf];
      if (b >= B) continue;  // outside the histogram: ignored, as in plain
      unsigned long long* e = hist + (j * B + b) * 3;
      if (g != 0) atomicAdd(e, (unsigned long long)g);
      if (h != 0) atomicAdd(e + 1, (unsigned long long)h);
      if (c != 0) atomicAdd(e + 2, (unsigned long long)c);
    }
  }
  __syncthreads();

  // entry (j, b, k) of the group is out[((f0 + j) * B + b) * 3 + k]
  unsigned long long* dst = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const unsigned long long v = hist[i];
    if (v != 0ULL) atomicAdd(dst + i, v);
  }
}

__device__ __forceinline__ void add3(unsigned long long* e, long long g,
                                     long long h, long long c) {
  if (g != 0) atomicAdd(e, (unsigned long long)g);
  if (h != 0) atomicAdd(e + 1, (unsigned long long)h);
  if (c != 0) atomicAdd(e + 2, (unsigned long long)c);
}

// bins: (F, nb) contiguous packed bytes; w: (3, 2 * nb) contiguous int64.
__global__ void hist_single_p4_kernel(const uint8_t* __restrict__ bins,
                                      const long long* __restrict__ w,
                                      unsigned long long* __restrict__ out,
                                      int F, long long nb, int B, int fg,
                                      int chunk) {
  extern __shared__ unsigned long long hist[];
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const long long j0 = (long long)blockIdx.x * chunk;
  const long long j1 = min(nb, j0 + chunk);
  const long long N = 2 * nb;
  const int entries = nf * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) hist[i] = 0ULL;
  __syncthreads();

  for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const long long r = 2 * j;
    const long long g0 = w[r], h0 = w[N + r], c0 = w[2 * N + r];
    const long long g1 = w[r + 1], h1 = w[N + r + 1], c1 = w[2 * N + r + 1];
    const bool a0 = (g0 | h0 | c0) != 0, a1 = (g1 | h1 | c1) != 0;
    if (!(a0 || a1)) continue;  // the pair contributes nothing
    const uint8_t* col = bins + (long long)f0 * nb + j;
    for (int k = 0; k < nf; ++k) {
      const int v = col[k * nb];
      const int b0 = v & 15, b1 = v >> 4;
      unsigned long long* hk = hist + k * B * 3;
      // bins outside the histogram are ignored, as in plain
      if (a0 && b0 < B) add3(hk + b0 * 3, g0, h0, c0);
      if (a1 && b1 < B) add3(hk + b1 * 3, g1, h1, c1);
    }
  }
  __syncthreads();

  unsigned long long* dst = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const unsigned long long v = hist[i];
    if (v != 0ULL) atomicAdd(dst + i, v);
  }
}

}  // namespace

extern "C" {

// (F, B, 3) int64 histogram of fixed-point weights, accumulated into `out`
// (zero-filled by the caller).  Strides are in elements: bins[f * sf + r *
// sn] is feature f of row r, w[k * ws + r] weight channel k of row r.
int hist_single(const void* bins, long long sf, long long sn, const void* w,
                long long ws, void* out, int F, int n, int B, int fg,
                int chunk, int threads, void* stream) {
  if (F <= 0 || n <= 0) return 0;
  const size_t smem = (size_t)fg * B * 3 * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      hist_single_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + chunk - 1) / chunk, (F + fg - 1) / fg);
  hist_single_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), sf, sn,
      static_cast<const long long*>(w), ws,
      static_cast<unsigned long long*>(out), F, n, B, fg, chunk);
  return (int)cudaGetLastError();
}

// The packed form: bins (F, nb) contiguous nibble-packed bytes (N = 2 * nb
// rows), w (3, N) contiguous int64, B <= 16, `chunk` bytes per block;
// accumulated into `out` (F, B, 3) int64, zero-filled by the caller.
int hist_single_p4(const void* bins, const void* w, void* out, int F,
                   long long nb, int B, int fg, int chunk, int threads,
                   void* stream) {
  if (F <= 0 || nb <= 0) return 0;
  const size_t smem = (size_t)fg * B * 3 * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      hist_single_p4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((nb + chunk - 1) / chunk), (F + fg - 1) / fg);
  hist_single_p4_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), static_cast<const long long*>(w),
      static_cast<unsigned long long*>(out), F, nb, B, fg, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Wave row update for the wave grower, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py:
//   * wave_row_update_pallas (_row_update_kernel, and the DMA form
//     _row_update_kernel_dma): apply a wave's W numeric splits to every row
//     in one pass, returning the new row->leaf vector and the
//     smaller-child channel of each row;
//   * wave_trial_channels_pallas: the same pass with new_right_id set to
//     the split leaf, so row->leaf is unchanged and only the channel of
//     each row's would-be smaller side comes back (the exact endgame).
//
// Semantics are those of _row_update_kernel (histogram_pallas.py:1097-1113)
// exactly: the W splits are applied in order j = 0..W-1 to the running
// row->leaf value, so a row rerouted by split j can be caught by a later
// split whose split_leaf is its new leaf; the channel is overwritten by
// every later split that matches.
//
// Design.  One thread per row.  The (8, W) int32 split table
// [threshold, nan_bin, default_left, left_is_smaller, split_leaf,
//  new_right_id, active, unused] is staged in shared memory once per
// block.  For each split the thread reads one byte of that split's winning
// feature column (cols_w is (W, N), so a warp reads 32 consecutive bytes).
//
// What bounds it on the H100: bytes.  Per row it reads W column bytes and
// 4 bytes of row->leaf and writes 4 + 1 bytes; at W = 25..42 and 10.5M
// rows that is 0.3-0.5 GB, 0.1-0.15 ms at 3.35 TB/s.  The compare/select
// work is a few integer operations per byte.  Loads are single bytes;
// packing four rows per thread into 32-bit loads is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;

template <bool kTrial>
__global__ void row_update_kernel(const uint8_t* __restrict__ cols,
                                  const int* __restrict__ rl_in,
                                  const int* __restrict__ tab,
                                  int* __restrict__ rl_out,
                                  int8_t* __restrict__ ch_out, int W, int N) {
  __shared__ int s_tab[8 * kMaxW];
  for (int i = threadIdx.x; i < 8 * W; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  int rl = rl_in[r];
  int ch = -1;
  for (int j = 0; j < W; ++j) {
    const int thr = s_tab[0 * W + j];
    const int nanb = s_tab[1 * W + j];
    const int dlft = s_tab[2 * W + j];
    const int small = s_tab[3 * W + j];
    const int selj = s_tab[4 * W + j];
    const int newid = s_tab[5 * W + j];
    const int act = s_tab[6 * W + j];
    const int col = cols[(long long)j * N + r];
    const int go_left = (col == nanb) ? dlft : (col <= thr ? 1 : 0);
    const bool upd = (rl == selj) && (act > 0);
    if (upd && go_left == small) ch = j;
    if (!kTrial && upd && go_left == 0) rl = newid;
  }
  if (!kTrial) rl_out[r] = rl;
  ch_out[r] = (int8_t)ch;
}

}  // namespace

extern "C" {

// cols (W, N) uint8, rl (N,) int32, tab (8, W) int32 ->
// rl_out (N,) int32, ch_out (N,) int8.
int wave_row_update(const void* cols, const void* rl, const void* tab,
                    void* rl_out, void* ch_out, int W, int N, int threads,
                    void* stream) {
  if (W > kMaxW) return (int)cudaErrorInvalidValue;
  const int blocks = (N + threads - 1) / threads;
  row_update_kernel<false><<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(rl),
      static_cast<const int*>(tab), static_cast<int*>(rl_out),
      static_cast<int8_t*>(ch_out), W, N);
  return (int)cudaGetLastError();
}

// Trial form: rl is read, never written; ch_out (N,) int8.
int wave_trial_channels(const void* cols, const void* rl, const void* tab,
                        void* ch_out, int W, int N, int threads,
                        void* stream) {
  if (W > kMaxW) return (int)cudaErrorInvalidValue;
  const int blocks = (N + threads - 1) / threads;
  row_update_kernel<true><<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(rl),
      static_cast<const int*>(tab), nullptr, static_cast<int8_t*>(ch_out), W,
      N);
  return (int)cudaGetLastError();
}

}  // extern "C"

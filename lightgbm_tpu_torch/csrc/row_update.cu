// Wave row update for the wave grower, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram_pallas.py:
//   * wave_row_update_pallas (:1280; _row_update_kernel :1093 via the
//     pallas_call at :1255, and the DMA form _row_update_kernel_dma :1118
//     via :1220): apply a wave's W numeric splits to every row in one
//     pass, returning the new row->leaf vector and the smaller-child
//     channel of each row;
//   * wave_trial_channels_pallas (:1314): the same pass with new_right_id
//     set to the split leaf, so row->leaf is unchanged and only the
//     channel of each row's would-be smaller side comes back (the exact
//     endgame).
//
// Semantics are those of _row_update_kernel (histogram_pallas.py:1097-1113)
// exactly: the W splits are applied in order j = 0..W-1 to the running
// row->leaf value, so a row rerouted by split j can be caught by a later
// split whose split_leaf is its new leaf; the channel is overwritten by
// every later split that matches; the trial form never writes row->leaf.
//
// The split columns are read IN PLACE from the grower's bin matrix: uint8
// (F, n) or nibble-packed (F, n/2) (row 2j in the low nibble of byte j),
// with a per-split feature index (clamped into [0, F), as the plain
// version's gather clamps it; no column is read for an inactive split).
// The reference, and the first version of this kernel, took a gathered
// (W, N) copy of the winning columns (unpacked under packed bins).
//
// What bounds it on the H100: bytes.  Per row: row->leaf in (4 B) and out
// (4 B, not in the trial form), the channel out (1 B), and one column byte
// (half under packed bins) for each split whose leaf the row is in as the
// splits apply: 9-10 bytes a row, about 0.1 GB and 0.03 ms at 10.5M rows
// and 3.35 TB/s.  A column byte costs its 32-byte sector where few rows of
// a split's leaf lie close together.
//
// Design.  One resident round of 256-thread blocks (as many as the
// occupancy API says the SMs hold) walks the rows; a thread takes two
// quads of 4 consecutive rows a step, each with row->leaf in as one
// 16-byte load, out as one 16-byte store and the channels as one 4-byte
// store.  Each block first builds in shared memory the (8, W) table [threshold, nan_bin,
// default_left, left_is_smaller, split_leaf, new_right_id, active,
// unused], each split's column offset, a hash from a leaf to its first
// active split, and for each split the first later active split of its
// split_leaf and of its new_right_id.  A row then finds its split with one
// lookup, with no walk over the W splits; its split is its last unless a
// later split takes the leaf the row is left in (the endgame's flush of a
// split and then its child), so the column bytes of a thread's eight rows
// are loaded together after the lookups, one byte per row that a split
// takes; a row no split takes costs its 9 bytes.  A chained split reads
// its byte at once and follows its link.  The first version read all W
// column bytes of every row; a version that loaded each split's column
// while walking the table ran the trial form slower than that (each load
// waited on the one before), and one that walked the table and deferred
// the loads spent ~300 instructions a thread on the walk (PERF.md section
// 6).
//
// The categorical / EFB form (wave_row_update_ext) replaces the XLA
// fallback the reference runs for those shapes (lightgbm_tpu/learner/
// wave.py:1341-1420: a (W, B) membership table and efb.make_bundle_decode
// over the gathered columns).  Its block also holds, per split, a decode
// row [is_categorical, f_offset, f_nbins, f_default, f_single] and a
// 256-bit membership bitset in shared memory (W x 52 bytes); each
// decision first turns the bundle column's byte into the feature's bin
// (the inverse of efb.py's offset encoding) and a categorical split then
// reads its bit.  The walk over a row's splits is the numeric form's, so
// both forms keep the in-order semantics above.  It reads the same bytes
// as the numeric form and adds a few integer operations a row; the
// numeric form is compiled without them.
//
// uint16 bin codes (max_bin > 255; the reference's wave grower then runs
// its XLA row update): every form is templated on the bin type
// (wave_row_update_u16, wave_row_update_ext_u16, wave_trial_channels_u16,
// and the model-axis forms *_lanes_u16); a split's code is one 2-byte load
// where it was one byte, nothing else changes.  The categorical / EFB
// form keeps its 256-bit membership (a code past 255 wraps its word index
// there): the learner refuses a categorical feature of more than 256 bins
// on the wave grower.
//
// Times (NVIDIA H100 80GB HBM3, 700.00 W): chip_smoke.py phase 2 (CUDA
// events behind a spinning kernel, W=25, N=10,502,144, rows over 255
// leaves) 0.098 ms, trial form 0.073 ms, where the first version took
// 0.279 and 0.224 ms on the same timer; on the wave grower's own traffic
// (torch.profiler) 0.072-0.079 ms a launch, where the first version took
// 0.226 ms, and 0.34 ms a trial launch, on top of the gather (and
// unpack) of the winning columns.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 128;
constexpr int kThreads = 256;
constexpr int kQuads = 2;            // 4-row quads of a thread per step

constexpr int kSlots = 256;          // leaf -> first split, 2 x kMaxW
constexpr int kEmpty = INT_MIN;      // a free slot's key

template <typename BT>
__device__ __forceinline__ int bin_at(const BT* __restrict__ col,
                                      long long row, bool packed) {
  return packed ? (__ldg(col + (row >> 1)) >> ((row & 1) * 4)) & 15
                : __ldg(col + row);
}

__device__ __forceinline__ int slot_of(int leaf) {
  return (int)(((unsigned int)leaf * 2654435761u) >> 24);
}

struct Table {
  int tab[8 * kMaxW];
  long long off[kMaxW];
  int next_left[kMaxW];    // first later active split of split_leaf
  int next_right[kMaxW];   // first later active split of new_right_id
  int key[kSlots];
  int first[kSlots];       // first active split of the slot's leaf
  int first_min;           // ... of leaf INT_MIN, which no slot can key
};

constexpr int kWords = 8;           // 256-bit membership of a split

// The categorical / EFB form's per-split table; empty in the numeric form.
template <bool kExt>
struct Ext {
  int dec[5 * kMaxW];                // is_cat, offset, nbins, default, single
  unsigned int member[kMaxW * kWords];
};
template <>
struct Ext<false> {};

// Split j's decision on its column byte v: 1 = left.
template <bool kExt>
__device__ __forceinline__ int decide(const Table& T, const Ext<kExt>& E,
                                      int j, int v, int W) {
  int b = v;
  if constexpr (kExt) {
    if (!E.dec[4 * W + j]) {
      const int u = v - E.dec[W + j];
      const int d = E.dec[3 * W + j];
      b = (u >= 0 && u < E.dec[2 * W + j] - 1) ? u + (u >= d ? 1 : 0) : d;
    }
    if (E.dec[j])
      return (int)((E.member[j * kWords + ((b >> 5) & (kWords - 1))] >>
                    (b & 31)) & 1u);
  }
  return (b == T.tab[W + j]) ? T.tab[2 * W + j] : (b <= T.tab[j] ? 1 : 0);
}

// The first active split whose split_leaf is `leaf`, or W.
__device__ __forceinline__ int first_split(const Table& T, int leaf, int W) {
  if (leaf == kEmpty) return T.first_min;
  for (int s = slot_of(leaf);; s = (s + 1) & (kSlots - 1)) {
    const int k = T.key[s];
    if (k == leaf) return T.first[s];
    if (k == kEmpty) return W;
  }
}

// vec: rl, rl_out (16 B) and ch (4 B) aligned for vector access.
// dec (5, W), member (W, kWords): the categorical / EFB form's inputs.
// BT: uint8 or uint16 codes (kPacked: uint8 bytes of two codes); fstride
// in elements.
template <bool kTrial, bool kPacked, bool kExt, typename BT>
__global__ void __launch_bounds__(kThreads)
row_update_kernel(const BT* __restrict__ bins, long long fstride, int F,
                  const int* __restrict__ feats, const int* __restrict__ rl_in,
                  const int* __restrict__ tab, int* __restrict__ rl_out,
                  int8_t* __restrict__ ch_out, const int* __restrict__ dec,
                  const int* __restrict__ member, int W, long long N,
                  int vec, const long long* __restrict__ lanes, int L) {
  __shared__ Table T;
  __shared__ Ext<kExt> E;
  if (lanes) {   // the model-axis form: lane blockIdx.y's inputs
    const int z = blockIdx.y;
    feats = reinterpret_cast<const int*>(lanes[z]);
    rl_in = reinterpret_cast<const int*>(lanes[L + z]);
    tab = reinterpret_cast<const int*>(lanes[2 * L + z]);
    if constexpr (kExt) {
      dec = reinterpret_cast<const int*>(lanes[3 * L + z]);
      member = reinterpret_cast<const int*>(lanes[4 * L + z]);
    }
    if (!kTrial) rl_out += (long long)z * N;
    ch_out += (long long)z * N;
  }
  for (int i = threadIdx.x; i < 8 * W; i += blockDim.x) T.tab[i] = tab[i];
  if constexpr (kExt) {
    for (int i = threadIdx.x; i < 5 * W; i += blockDim.x) E.dec[i] = dec[i];
    for (int i = threadIdx.x; i < kWords * W; i += blockDim.x)
      E.member[i] = (unsigned int)member[i];
  }
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    T.key[i] = kEmpty;
    T.first[i] = W;
  }
  if (threadIdx.x == 0) T.first_min = W;
  __syncthreads();
  const int* act = T.tab + 6 * W;
  const int* sel = T.tab + 4 * W;
  const int* nid = T.tab + 5 * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int f = feats ? feats[j] : j;
    T.off[j] = (long long)min(max(f, 0), F - 1) * fstride;
    int nl = W, nr = W;
    for (int k = W - 1; k > j; --k) {
      if (act[k] <= 0) continue;
      if (sel[k] == sel[j]) nl = k;
      if (sel[k] == nid[j]) nr = k;
    }
    T.next_left[j] = nl;
    T.next_right[j] = kTrial ? nl : nr;
    if (act[j] <= 0) continue;
    if (sel[j] == kEmpty) {
      atomicMin(&T.first_min, j);
      continue;
    }
    for (int s = slot_of(sel[j]);; s = (s + 1) & (kSlots - 1)) {
      const int k = atomicCAS(&T.key[s], kEmpty, sel[j]);
      if (k == kEmpty || k == sel[j]) {
        atomicMin(&T.first[s], j);
        break;
      }
    }
  }
  __syncthreads();

  // rows [4q, 4q + 4) of quads q = base + threadIdx.x + k * blockDim.x,
  // k < kQuads: each load and store instruction of a warp is contiguous
  const long long quads = (N + 3) / 4;
  const long long span = (long long)blockDim.x * kQuads;
  for (long long base = (long long)blockIdx.x * span; base < quads;
       base += (long long)gridDim.x * span) {
    long long r[kQuads];
    int nv[kQuads];
    int rl[kQuads][4];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      r[k] = 4 * (base + threadIdx.x + (long long)k * blockDim.x);
      nv[k] = (int)max(0LL, min(4LL, N - r[k]));
      if ((vec & 1) && nv[k] == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(rl_in + r[k]));
        rl[k][0] = v.x; rl[k][1] = v.y; rl[k][2] = v.z; rl[k][3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rl[k][i] = i < nv[k] ? __ldg(rl_in + r[k] + i) : 0;
      }
    }
    int ch[kQuads][4];
    int last[kQuads][4];   // each row's last split, applied after the loads
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ch[k][i] = -1;
        int j = i < nv[k] ? first_split(T, rl[k][i], W) : W;
        // a split followed by a later one of the row's leaf (the endgame's
        // flush of a split and then its child) is applied at once
        while (j < W && (T.next_left[j] < W || T.next_right[j] < W)) {
          const int go_left =
              decide(T, E, j, bin_at(bins + T.off[j], r[k] + i, kPacked), W);
          if (go_left == T.tab[3 * W + j]) ch[k][i] = j;
          if (!kTrial && go_left == 0) rl[k][i] = nid[j];
          j = go_left ? T.next_left[j] : T.next_right[j];
        }
        last[k][i] = j;
      }
    }
    int b[kQuads][4];
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b[k][i] = last[k][i] < W
                      ? bin_at(bins + T.off[last[k][i]], r[k] + i, kPacked)
                      : 0;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = last[k][i];
        if (j >= W) continue;
        const int go_left = decide(T, E, j, b[k][i], W);
        if (go_left == T.tab[3 * W + j]) ch[k][i] = j;
        if (!kTrial && go_left == 0) rl[k][i] = nid[j];
      }
      if ((vec & 1) && nv[k] == 4) {
        if (!kTrial)
          *reinterpret_cast<int4*>(rl_out + r[k]) =
              make_int4(rl[k][0], rl[k][1], rl[k][2], rl[k][3]);
        *reinterpret_cast<unsigned int*>(ch_out + r[k]) =
            (unsigned int)(uint8_t)ch[k][0] |
            ((unsigned int)(uint8_t)ch[k][1] << 8) |
            ((unsigned int)(uint8_t)ch[k][2] << 16) |
            ((unsigned int)(uint8_t)ch[k][3] << 24);
      } else {
        for (int i = 0; i < nv[k]; ++i) {
          if (!kTrial) rl_out[r[k] + i] = rl[k][i];
          ch_out[r[k] + i] = (int8_t)ch[k][i];
        }
      }
    }
  }
}

// lanes: null for one lane, else the device table (3, L), or (5, L) in
// the categorical / EFB form, of each lane's feats, rl, tab[, dec,
// member] pointers, with rl_out and ch_out the lanes' (L, N).
template <bool kTrial, bool kExt, typename BT = uint8_t>
int launch(const void* bins, long long fstride, int F, const void* feats,
           const void* rl, const void* tab, void* rl_out, void* ch_out,
           const void* dec, const void* member, int W, long long N,
           int packed, int vec, void* stream,
           const long long* lanes = nullptr, int L = 1) {
  if (W > kMaxW || (F <= 0 && W > 0)) return (int)cudaErrorInvalidValue;
  if ((kExt || sizeof(BT) != 1) && packed) return (int)cudaErrorInvalidValue;
  if (kExt && (!dec || !member) && !lanes) return (int)cudaErrorInvalidValue;
  if (L > 65535) return (int)cudaErrorInvalidValue;
  if (N <= 0 || L <= 0) return 0;
  auto* kern = packed ? row_update_kernel<kTrial, true, false, BT>
                      : row_update_kernel<kTrial, false, kExt, BT>;
  // one resident round: as many blocks as the SMs hold, or fewer
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long span = (long long)kThreads * kQuads;
  const long long need = ((N + 3) / 4 + span - 1) / span;
  // the lanes share the resident round
  long long most = per_sm * sms > 0 ? (long long)per_sm * sms : 1;
  most = most / L > 0 ? most / L : 1;
  const int blocks = (int)(need < most ? need : most);
  kern<<<dim3(blocks, L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BT*>(bins), fstride, F,
      static_cast<const int*>(feats), static_cast<const int*>(rl),
      static_cast<const int*>(tab), static_cast<int*>(rl_out),
      static_cast<int8_t*>(ch_out), static_cast<const int*>(dec),
      static_cast<const int*>(member), W, N, vec, lanes, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bins: the (F, fstride) bin matrix, uint8 or nibble-packed (packed = 1);
// feats: (W,) int32 feature of each split, or null for split j reading row
// j; rl (N,) int32, tab (8, W) int32 -> rl_out (N,) int32, ch_out (N,)
// int8.
int wave_row_update(const void* bins, long long fstride, int F,
                    const void* feats, const void* rl, const void* tab,
                    void* rl_out, void* ch_out, int W, long long N,
                    int packed, int vec, void* stream) {
  return launch<false, false>(bins, fstride, F, feats, rl, tab, rl_out,
                              ch_out, nullptr, nullptr, W, N, packed, vec,
                              stream);
}

// Categorical / EFB form (uint8 bins): dec (5, W) int32 rows
// [is_categorical, f_offset, f_nbins, f_default, f_single], member
// (W, 8) int32 bitsets of the bins that go left.
int wave_row_update_ext(const void* bins, long long fstride, int F,
                        const void* feats, const void* rl, const void* tab,
                        void* rl_out, void* ch_out, const void* dec,
                        const void* member, int W, long long N, int packed,
                        int vec, void* stream) {
  return launch<false, true>(bins, fstride, F, feats, rl, tab, rl_out,
                             ch_out, dec, member, W, N, packed, vec, stream);
}

// The uint16 forms (max_bin > 255): bins the (F, fstride) uint16 codes,
// fstride in elements; never packed.
int wave_row_update_u16(const void* bins, long long fstride, int F,
                        const void* feats, const void* rl, const void* tab,
                        void* rl_out, void* ch_out, int W, long long N,
                        int vec, void* stream) {
  return launch<false, false, uint16_t>(bins, fstride, F, feats, rl, tab,
                                        rl_out, ch_out, nullptr, nullptr, W,
                                        N, 0, vec, stream);
}

int wave_row_update_ext_u16(const void* bins, long long fstride, int F,
                            const void* feats, const void* rl,
                            const void* tab, void* rl_out, void* ch_out,
                            const void* dec, const void* member, int W,
                            long long N, int vec, void* stream) {
  return launch<false, true, uint16_t>(bins, fstride, F, feats, rl, tab,
                                       rl_out, ch_out, dec, member, W, N, 0,
                                       vec, stream);
}

int wave_trial_channels_u16(const void* bins, long long fstride, int F,
                            const void* feats, const void* rl,
                            const void* tab, void* ch_out, int W,
                            long long N, int vec, void* stream) {
  return launch<true, false, uint16_t>(bins, fstride, F, feats, rl, tab,
                                       nullptr, ch_out, nullptr, nullptr, W,
                                       N, 0, vec, stream);
}

// Trial form: rl is read, never written; ch_out (N,) int8.
int wave_trial_channels(const void* bins, long long fstride, int F,
                        const void* feats, const void* rl, const void* tab,
                        void* ch_out, int W, long long N, int packed, int vec,
                        void* stream) {
  return launch<true, false>(bins, fstride, F, feats, rl, tab, nullptr,
                             ch_out, nullptr, nullptr, W, N, packed, vec,
                             stream);
}

// The model-axis forms (the reference's vmap of the entry points above,
// the batch axis a leading grid dimension): L lanes apply their own W
// splits to their own row->leaf vectors, reading the shared bin matrix in
// place.  lanes: device int64 table (3, L) [feats, rl, tab pointers of
// lane l], (5, L) with [dec, member] in the categorical / EFB form;
// rl_out and ch_out (L, N).  vec: every lane's rl 16-byte aligned and N a
// multiple of 4.  Grid (blocks, L): lane l's blocks build lane l's table
// and walk its rows as the single form does.
int wave_row_update_lanes(const void* bins, long long fstride, int F,
                          const void* lanes, void* rl_out, void* ch_out,
                          int L, int W, long long N, int packed, int vec,
                          void* stream) {
  return launch<false, false>(bins, fstride, F, nullptr, nullptr, nullptr,
                              rl_out, ch_out, nullptr, nullptr, W, N, packed,
                              vec, stream,
                              static_cast<const long long*>(lanes), L);
}

int wave_row_update_ext_lanes(const void* bins, long long fstride, int F,
                              const void* lanes, void* rl_out, void* ch_out,
                              int L, int W, long long N, int packed, int vec,
                              void* stream) {
  return launch<false, true>(bins, fstride, F, nullptr, nullptr, nullptr,
                             rl_out, ch_out, nullptr, nullptr, W, N, packed,
                             vec, stream,
                             static_cast<const long long*>(lanes), L);
}

int wave_trial_channels_lanes(const void* bins, long long fstride, int F,
                              const void* lanes, void* ch_out, int L, int W,
                              long long N, int packed, int vec,
                              void* stream) {
  return launch<true, false>(bins, fstride, F, nullptr, nullptr, nullptr,
                             nullptr, ch_out, nullptr, nullptr, W, N, packed,
                             vec, stream,
                             static_cast<const long long*>(lanes), L);
}

// The model-axis forms over uint16 codes (max_bin > 255; the reference's
// vmap of its XLA row update): the lanes forms above with 2-byte codes,
// fstride in elements; packed must be 0.
int wave_row_update_lanes_u16(const void* bins, long long fstride, int F,
                              const void* lanes, void* rl_out, void* ch_out,
                              int L, int W, long long N, int packed, int vec,
                              void* stream) {
  return launch<false, false, uint16_t>(
      bins, fstride, F, nullptr, nullptr, nullptr, rl_out, ch_out, nullptr,
      nullptr, W, N, packed, vec, stream,
      static_cast<const long long*>(lanes), L);
}

int wave_row_update_ext_lanes_u16(const void* bins, long long fstride, int F,
                                  const void* lanes, void* rl_out,
                                  void* ch_out, int L, int W, long long N,
                                  int packed, int vec, void* stream) {
  return launch<false, true, uint16_t>(
      bins, fstride, F, nullptr, nullptr, nullptr, rl_out, ch_out, nullptr,
      nullptr, W, N, packed, vec, stream,
      static_cast<const long long*>(lanes), L);
}

int wave_trial_channels_lanes_u16(const void* bins, long long fstride,
                                  int F, const void* lanes, void* ch_out,
                                  int L, int W, long long N, int packed,
                                  int vec, void* stream) {
  return launch<true, false, uint16_t>(
      bins, fstride, F, nullptr, nullptr, nullptr, nullptr, ch_out, nullptr,
      nullptr, W, N, packed, vec, stream,
      static_cast<const long long*>(lanes), L);
}

}  // extern "C"

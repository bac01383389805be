// K9 — max over gathered rows for slab-structured indices (region and
// refine pooling in slab mode), with its argmax form for training.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, gather_max_slab
//   (_gmax_slab_kernel, slab.py:1072).
// Bound on the H100: memory traffic from L2.  Each output value is a max
//   over up to K gathered rows (S*K*C floats, 1 GB for the region pool at
//   4,000 x 256 x 256) where the function's own inputs are 26 MB of
//   features, which fit the 50 MB L2, and 4 MB of indices.
// Design: the TPU kernel fetches, per tile and span block, a 2,048-row
//   window of features and picks rows out of it with one-hot matrix products
//   over a 3-way bf16 split, because the TPU has no fast gather; a slot whose
//   row lies outside its own window gets an all-zero one-hot and so drops
//   out.  Here it is a direct gather that keeps that cover rule, since the
//   rule decides the result for rows with no pick (they pool to -1e38) and
//   for partly filled rows: one block per (batch, query) marks the covered
//   slots in shared memory once, and each thread owns channels c,
//   c + blockDim, ... and loops over the covered rows, so every row read is
//   coalesced along c.  The result is bit-exact (a max of copied values).
//   Training uses the argmax form (slab.py:996-1014), which also writes the
//   winner's source row: the lowest covered slot holding the maximum, 0 for
//   a row with no covered slot.  Its backward is the scatter kernel of
//   gather_max.cu.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;    // queries per tile (one `off` each)
constexpr int kScan = 2048;   // rows per scan block
constexpr float kBig = 1e38f;

__global__ void gather_max_slab_kernel(const float* __restrict__ feature,
                                       const int32_t* __restrict__ index,
                                       const int32_t* __restrict__ off_blk,
                                       float* __restrict__ out, int n,
                                       int c_total, int s_total, int k_total,
                                       int win, int spw) {
  extern __shared__ int s_row[];  // [K] covered row, or -1
  const int b = blockIdx.y, s = blockIdx.x;
  const size_t row = (size_t)b * s_total + s;
  const int tiles = (s_total + kTile - 1) / kTile;
  const int off = off_blk[(size_t)b * tiles + s / kTile];
  const int rps = (kScan / win) * spw;  // slots per scan block
  for (int k = threadIdx.x; k < k_total; k += blockDim.x) {
    const int r = index[row * k_total + k];
    const int base = (off + k / rps) * kScan + (k % rps) / spw * win;
    s_row[k] = (r >= base && r < base + win && r < n) ? r : -1;
  }
  __syncthreads();
  feature += (size_t)b * n * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    float m = -kBig;
    for (int k = 0; k < k_total; ++k) {
      const int r = s_row[k];
      if (r < 0) continue;
      const float v = feature[(size_t)r * c_total + c];
      if (v > m || v != v) m = v;
    }
    out[row * c_total + c] = m;
  }
}

__global__ void gather_max_slab_argmax_kernel(
    const float* __restrict__ feature, const int32_t* __restrict__ index,
    const int32_t* __restrict__ off_blk, float* __restrict__ out,
    int32_t* __restrict__ winner, int n, int c_total, int s_total,
    int k_total, int win, int spw) {
  extern __shared__ int s_row[];  // [K] covered row, or -1
  const int b = blockIdx.y, s = blockIdx.x;
  const size_t row = (size_t)b * s_total + s;
  const int tiles = (s_total + kTile - 1) / kTile;
  const int off = off_blk[(size_t)b * tiles + s / kTile];
  const int rps = (kScan / win) * spw;  // slots per scan block
  for (int k = threadIdx.x; k < k_total; k += blockDim.x) {
    const int r = index[row * k_total + k];
    const int base = (off + k / rps) * kScan + (k % rps) / spw * win;
    s_row[k] = (r >= base && r < base + win && r < n) ? r : -1;
  }
  __syncthreads();
  feature += (size_t)b * n * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    float m = -kBig;
    int w = 0;
    for (int k = 0; k < k_total; ++k) {
      const int r = s_row[k];
      if (r < 0) continue;
      const float v = feature[(size_t)r * c_total + c];
      if (v > m) {
        m = v;
        w = r;
      }
    }
    out[row * c_total + c] = m;
    winner[row * c_total + c] = w;
  }
}

}  // namespace

// feature [B, N, C] f32, index [B, S, K] int32, off_blk [B, ceil(S/128)]
// int32 -> out [B, S, C]: the max over the slots k whose row lies in the
// slot's own window [(off + k / rps) * 2048 + (k % rps) / spw * win, + win),
// -1e38 where no slot is covered.
extern "C" int regnet_gather_max_slab(const float* feature,
                                      const int32_t* index,
                                      const int32_t* off_blk, float* out,
                                      int batch, int n, int c_total,
                                      int s_total, int k_total, int win,
                                      int spw, cudaStream_t stream) {
  const int threads = c_total < 256 ? ((c_total + 31) / 32) * 32 : 256;
  dim3 grid(s_total, batch);
  gather_max_slab_kernel<<<grid, threads, k_total * sizeof(int), stream>>>(
      feature, index, off_blk, out, n, c_total, s_total, k_total, win, spw);
  return (int)cudaGetLastError();
}

// The same, and winner [B, S, C] int32: the row of the lowest covered slot
// holding the maximum, 0 where no slot is covered.
extern "C" int regnet_gather_max_slab_argmax(
    const float* feature, const int32_t* index, const int32_t* off_blk,
    float* out, int32_t* winner, int batch, int n, int c_total, int s_total,
    int k_total, int win, int spw, cudaStream_t stream) {
  const int threads = c_total < 256 ? ((c_total + 31) / 32) * 32 : 256;
  dim3 grid(s_total, batch);
  gather_max_slab_argmax_kernel<<<grid, threads, k_total * sizeof(int),
                                  stream>>>(feature, index, off_blk, out,
                                            winner, n, c_total, s_total,
                                            k_total, win, spw);
  return (int)cudaGetLastError();
}

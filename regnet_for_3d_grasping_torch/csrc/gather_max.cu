// K4 — max over gathered rows (region and refine pooling).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/pooling.py, gather_max_pallas
//   (_kernel, dispatched from ops/pooling.py:270 for the region pool at
//   models/regnet.py:270).
// Bound on the H100: memory traffic from L2.  Each output value is a max
//   over K gathered rows, so the kernel reads S*K*C floats (1 GB for the
//   region pool at 4,000 x 256 x 256) where the function's own inputs are
//   26 MB of features (which fit the 50 MB L2) and 4 MB of indices.
// Design: the TPU kernel's one-hot matrix products and 3-way bf16 split
//   exist only because the TPU has no fast gather.  Here it is a direct
//   gather: one block per (batch, proposal) loads the K indices into shared
//   memory once, and each thread owns channels c, c+blockDim, ... and loops
//   over the K rows, so every row read is coalesced along c.  The result is
//   bit-exact (a max of copied values); a NaN wins as in torch.amax.  The
//   argmax output and the first-winner backward belong to the training
//   slice.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void gather_max_kernel(const float* __restrict__ feature,
                                  const int32_t* __restrict__ index,
                                  float* __restrict__ out, int n, int c_total,
                                  int s_total, int k_total) {
  extern __shared__ int s_idx[];  // [K]
  const int b = blockIdx.y, s = blockIdx.x;
  const size_t row = (size_t)b * s_total + s;
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    s_idx[k] = index[row * k_total + k];
  __syncthreads();
  feature += (size_t)b * n * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    float m = feature[(size_t)s_idx[0] * c_total + c];
    for (int k = 1; k < k_total; ++k) {
      const float v = feature[(size_t)s_idx[k] * c_total + c];
      if (v > m || v != v) m = v;
    }
    out[row * c_total + c] = m;
  }
}

}  // namespace

// feature [B, N, C] f32, index [B, S, K] int32 in [0, N) ->
// out [B, S, C] = max_k feature[b, index[b, s, k], c].
extern "C" int regnet_gather_max(const float* feature, const int32_t* index,
                                 float* out, int batch, int n, int c_total,
                                 int s_total, int k_total,
                                 cudaStream_t stream) {
  const int threads = c_total < 256 ? ((c_total + 31) / 32) * 32 : 256;
  dim3 grid(s_total, batch);
  gather_max_kernel<<<grid, threads, k_total * sizeof(int), stream>>>(
      feature, index, out, n, c_total, s_total, k_total);
  return (int)cudaGetLastError();
}

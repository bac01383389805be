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
//   bit-exact (a max of copied values); a NaN wins as in torch.amax.
//   Training uses the argmax form, which also writes the winner's source
//   row: the lowest slot holding the maximum (strict `>` while walking up
//   the slots), the rule of the TPU kernel's `with_argmax` output
//   (pooling.py:146-167) and of argmax-then-take (pooling.py:241-246).
//   The backward, an XLA scatter-add in the JAX package (pooling.py:285-296),
//   is `scatter_winner_kernel`: dfeature[b, win[b,s,c], c] += g[b,s,c].  One
//   thread owns one (batch, channel) column and walks the S rows in order,
//   so no two threads touch one address and the sum order is fixed: the
//   gradient is deterministic, with no atomics.  It is bound by its S
//   dependent read-modify-writes per thread (64 at the training shape).

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

__global__ void gather_max_argmax_kernel(const float* __restrict__ feature,
                                         const int32_t* __restrict__ index,
                                         float* __restrict__ out,
                                         int32_t* __restrict__ win, int n,
                                         int c_total, int s_total,
                                         int k_total) {
  extern __shared__ int s_idx[];  // [K]
  const int b = blockIdx.y, s = blockIdx.x;
  const size_t row = (size_t)b * s_total + s;
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    s_idx[k] = index[row * k_total + k];
  __syncthreads();
  feature += (size_t)b * n * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    float m = feature[(size_t)s_idx[0] * c_total + c];
    int w = s_idx[0];
    for (int k = 1; k < k_total; ++k) {
      const float v = feature[(size_t)s_idx[k] * c_total + c];
      if (v > m) {
        m = v;
        w = s_idx[k];
      }
    }
    out[row * c_total + c] = m;
    win[row * c_total + c] = w;
  }
}

// dfeature must be zero on entry.  Thread (b, c) adds g[b, s, c] to
// dfeature[b, win[b, s, c], c] for s = 0, 1, ... in order.
__global__ void scatter_winner_kernel(const float* __restrict__ g,
                                      const int32_t* __restrict__ win,
                                      float* __restrict__ dfeature, int n,
                                      int c_total, int s_total) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_total) return;
  g += (size_t)b * s_total * c_total;
  win += (size_t)b * s_total * c_total;
  dfeature += (size_t)b * n * c_total;
  for (int s = 0; s < s_total; ++s) {
    const size_t at = (size_t)s * c_total + c;
    dfeature[(size_t)win[at] * c_total + c] += g[at];
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

// The same, and win [B, S, C] int32 = index[b, s, k*] with k* the lowest
// slot holding the maximum.
extern "C" int regnet_gather_max_argmax(const float* feature,
                                        const int32_t* index, float* out,
                                        int32_t* win, int batch, int n,
                                        int c_total, int s_total, int k_total,
                                        cudaStream_t stream) {
  const int threads = c_total < 256 ? ((c_total + 31) / 32) * 32 : 256;
  dim3 grid(s_total, batch);
  gather_max_argmax_kernel<<<grid, threads, k_total * sizeof(int), stream>>>(
      feature, index, out, win, n, c_total, s_total, k_total);
  return (int)cudaGetLastError();
}

// g [B, S, C] f32, win [B, S, C] int32 in [0, N) -> dfeature [B, N, C],
// zero on entry: dfeature[b, win[b, s, c], c] += g[b, s, c], in s order.
extern "C" int regnet_gather_max_backward(const float* g, const int32_t* win,
                                          float* dfeature, int batch, int n,
                                          int c_total, int s_total,
                                          cudaStream_t stream) {
  const int threads = 64;
  dim3 grid((c_total + threads - 1) / threads, batch);
  scatter_winner_kernel<<<grid, threads, 0, stream>>>(g, win, dfeature, n,
                                                      c_total, s_total);
  return (int)cudaGetLastError();
}

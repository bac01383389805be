// K3 — three nearest neighbours (FP3).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/knn_pallas.py, three_nn_pallas
//   (_knn_kernel, version 1, dispatched from ops/knn.py:52).
// Bound on the H100: arithmetic.  At the FP3 shape every one of 25,600
//   queries meets every one of 5,120 keys: 131 M distances of about 9
//   flops plus three compares each, over inputs of a few hundred KB.
// Design: one thread per query keeps its best three (distance, index) in
//   registers.  The block streams the keys through shared memory in tiles,
//   in ascending index order, and each thread inserts with strict `<`
//   compares, so among equal distances the smaller index stays ahead: the
//   result is the three smallest by (distance, index), ascending, as in the
//   TPU kernel.  Distances are diff-squares with explicit round-to-nearest
//   intrinsics in the JAX order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kInf = 3e38f;  // the TPU kernel's "no neighbour" distance

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ query, const float* __restrict__ key,
                int32_t* __restrict__ idx, float* __restrict__ dist, int n1,
                int n2) {
  __shared__ float sk[3][kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  query += (size_t)b * n1 * 3;
  key += (size_t)b * n2 * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < n1) {
    qx = query[3 * q];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
  }
  float d0 = kInf, d1 = kInf, d2 = kInf;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < n2; base += kTile) {
    const int len = min(kTile, n2 - base);
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * len; t += kThreads)
      sk[t % 3][t / 3] = key[3 * base + t];
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float dx = __fsub_rn(sk[0][t], qx);
      const float dy = __fsub_rn(sk[1][t], qy);
      const float dz = __fsub_rn(sk[2][t], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const int j = base + t;
      if (d < d2) {
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = j;
          } else {
            d1 = d;
            i1 = j;
          }
        } else {
          d2 = d;
          i2 = j;
        }
      }
    }
  }
  if (q < n1) {
    const size_t o = ((size_t)b * n1 + q) * 3;
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
    dist[o] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
  }
}

}  // namespace

// query [B, N1, 3], key [B, N2, 3] f32 -> idx [B, N1, 3] int32,
// dist [B, N1, 3] f32 squared distances, ascending.
extern "C" int regnet_three_nn(const float* query, const float* key,
                               int32_t* idx, float* dist, int batch, int n1,
                               int n2, cudaStream_t stream) {
  dim3 grid((n1 + kThreads - 1) / kThreads, batch);
  three_nn_kernel<<<grid, kThreads, 0, stream>>>(query, key, idx, dist, n1,
                                                  n2);
  return (int)cudaGetLastError();
}

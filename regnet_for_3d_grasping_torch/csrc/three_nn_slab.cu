// K8 — three nearest neighbours over each query tile's key span (FP3 in
// slab mode).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, three_nn_slab
//   (_three_nn_slab_kernel), through both of its grids: the bounded grid
//   (slab.py:853) and the flat grid (slab.py:885).  They differ only in the
//   span table they are given, which the wrapper computes; the kernel walks
//   whatever [start, stop) it finds.
// Bound on the H100: arithmetic.  A query meets only the keys of its tile's
//   span, about 2 of 5 blocks of 1,024 at the FP3 shape (25,600 queries,
//   5,120 keys): some 50 M distances of 9 flops plus three compares each,
//   over inputs of a few hundred KB.
// Design: one thread block per tile of 256 queries, one thread per query
//   with its best three (distance, index) in registers.  The block streams
//   the span's keys through shared memory in index order, and each thread
//   inserts with strict `<` compares, so among equal distances the smaller
//   index stays ahead: the three smallest by (distance, index), ascending,
//   which is what the TPU kernel's per-block top-3 and sorted merge give.
//   Distances are diff-squares with explicit round-to-nearest intrinsics in
//   the JAX order.  An empty slot holds (1e38, index 0).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 256;    // queries per tile, one thread each
constexpr int kKeys = 1024;   // keys per block
constexpr float kBig = 1e38f;

__global__ void __launch_bounds__(kTile)
three_nn_slab_kernel(const float* __restrict__ query,
                     const float* __restrict__ key,
                     const int32_t* __restrict__ ss, int32_t* __restrict__ idx,
                     float* __restrict__ dist, int nq, int nk) {
  __shared__ float sk[3][kKeys];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int q = tile * kTile + threadIdx.x;
  const int32_t* s2 = ss + ((size_t)b * gridDim.x + tile) * 2;
  const int start = s2[0], stop = s2[1];
  query += (size_t)b * nq * 3;
  key += (size_t)b * nk * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < nq) {
    qx = query[3 * q];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
  }
  float d0 = kBig, d1 = kBig, d2 = kBig;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int kb = start; kb < stop; ++kb) {
    const int base = kb * kKeys;
    const int len = min(kKeys, nk - base);
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * len; t += kTile)
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
  if (q < nq) {
    const size_t o = ((size_t)b * nq + q) * 3;
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
    dist[o] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
  }
}

}  // namespace

// query [B, Nq, 3], key [B, NK, 3] f32 (x-ascending), ss [B, T, 2] int32
// key-block span per tile of 256 queries -> idx [B, Nq, 3] int32,
// dist [B, Nq, 3] f32 squared distances, ascending.
extern "C" int regnet_three_nn_slab(const float* query, const float* key,
                                    const int32_t* ss, int32_t* idx,
                                    float* dist, int batch, int nq, int nk,
                                    cudaStream_t stream) {
  dim3 grid((nq + kTile - 1) / kTile, batch);
  three_nn_slab_kernel<<<grid, kTile, 0, stream>>>(query, key, ss, idx, dist,
                                                   nq, nk);
  return (int)cudaGetLastError();
}

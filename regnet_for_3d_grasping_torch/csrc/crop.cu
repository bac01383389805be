// K5 — gripper closing-region crop.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/crop_pallas.py,
//   closing_region_crop_pallas (_crop_kernel, dispatched from
//   geometry/region.py:399-408).
// Bound on the H100: arithmetic.  Every (proposal, point) pair is moved
//   into the gripper frame (9 multiplies, 9 adds), box-tested and hashed:
//   about 40 integer and float operations per pair, 102 M pairs at 4,000
//   proposals x 25,600 points, over inputs of a few hundred KB.
// Design: the same shape as the ball query (K2).  One block of 8 warps per
//   proposal; a warp takes one bucket of L points, 32 at a time.  A point's
//   key is its 23-bit hash noise when it lies inside the box and -1
//   otherwise; each lane keeps its best (key, index) with strict `>` while
//   walking up the bucket, and a warp shuffle reduction with ties to the
//   smaller index gives the bucket's first-index argmax, as in the TPU
//   kernel.  A ballot counts the inside points.  Empty buckets take the
//   first non-empty bucket's pick.  The frame products are rounded in the
//   JAX order with explicit round-to-nearest intrinsics, so the box test
//   matches the reference point for point.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float dot3(float a0, float r0, float a1, float r1,
                                      float a2, float r2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, r0), __fmul_rn(a1, r1)),
                   __fmul_rn(a2, r2));
}

__global__ void __launch_bounds__(kWarps * 32)
crop_kernel(const float* __restrict__ xyz, const float* __restrict__ frames,
            const float* __restrict__ centers, uint32_t seed,
            int32_t* __restrict__ idx, int32_t* __restrict__ count, int n,
            int m_total, int k_total, int bucket, float xlo, float xhi,
            float yabs, float zabs) {
  extern __shared__ int s_win[];  // [K]
  __shared__ int s_cnt[kWarps];
  __shared__ int s_first;

  const int b = blockIdx.y, m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)b * m_total + m;
  xyz += (size_t)b * n * 3;
  float f[9];  // row-major F[k][j]; columns are the gripper axes
  for (int e = 0; e < 9; ++e) f[e] = frames[row * 9 + e];
  const float cx = centers[row * 3], cy = centers[row * 3 + 1],
              cz = centers[row * 3 + 2];
  const uint32_t hrow = (uint32_t)m * 0x9E3779B9u + seed;

  int cnt = 0;
  for (int k = warp; k < k_total; k += kWarps) {
    const int base = k * bucket;
    int best = -1, best_j = INT_MAX;
    for (int t0 = 0; t0 < bucket && base + t0 < n; t0 += 32) {
      const int t = t0 + lane, j = base + t;
      bool inside = false;
      if (t < bucket && j < n) {
        const float r0 = __fsub_rn(xyz[3 * j], cx);
        const float r1 = __fsub_rn(xyz[3 * j + 1], cy);
        const float r2 = __fsub_rn(xyz[3 * j + 2], cz);
        const float l0 = dot3(f[0], r0, f[3], r1, f[6], r2);
        const float l1 = dot3(f[1], r0, f[4], r1, f[7], r2);
        const float l2 = dot3(f[2], r0, f[5], r1, f[8], r2);
        inside = l0 > xlo && l0 < xhi && fabsf(l1) < yabs && fabsf(l2) < zabs;
      }
      if (inside) {
        uint32_t h = hrow + (uint32_t)j * 2654435761u;
        h ^= h >> 16;
        h *= 0x45D9F3Bu;
        h ^= h >> 16;
        const int key = (int)(h >> 9);
        if (key > best) {
          best = key;
          best_j = j;
        }
      }
      cnt += __popc(__ballot_sync(0xffffffffu, inside));
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
      if (ob > best || (ob == best && oj < best_j)) {
        best = ob;
        best_j = oj;
      }
    }
    if (lane == 0) s_win[k] = best >= 0 ? best_j : -1;
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int first = 0;
    for (int k = 0; k < k_total; ++k)
      if (s_win[k] >= 0) {
        first = s_win[k];
        break;
      }
    s_first = first;
  }
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    idx[row * k_total + k] = s_win[k] >= 0 ? s_win[k] : s_first;
  if (threadIdx.x == 0) count[row] = total;
}

}  // namespace

// xyz [B, N, 3], frames [B, M, 3, 3], centers [B, M, 3] f32, u32 seed ->
// idx [B, M, K] int32 (0 where a row has no inside point), count [B, M]
// int32 exact inside count.  Box: xlo < x < xhi, |y| < yabs, |z| < zabs.
extern "C" int regnet_crop(const float* xyz, const float* frames,
                           const float* centers, uint32_t seed, int32_t* idx,
                           int32_t* count, int batch, int n, int m_total,
                           int k_total, int bucket, float xlo, float xhi,
                           float yabs, float zabs, cudaStream_t stream) {
  dim3 grid(m_total, batch);
  crop_kernel<<<grid, kWarps * 32, k_total * sizeof(int), stream>>>(
      xyz, frames, centers, seed, idx, count, n, m_total, k_total, bucket,
      xlo, xhi, yabs, zabs);
  return (int)cudaGetLastError();
}

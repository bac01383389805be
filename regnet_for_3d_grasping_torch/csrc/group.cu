// K11 — fused radius grouping of the proposal regions (full scan).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/group_pallas.py,
//   group_regions_pallas (_group_kernel, group_pallas.py:119, dispatched
//   from geometry/region.py:149-158).
// Bound on the H100: arithmetic.  Every (center, point) pair costs the
//   radius test (3 subtractions, 3 multiplies, 2 adds, 1 compare: 9
//   operations) and every pair in radius the counter hash and its place in
//   the bucket's argmax (10 more); the inputs are a few hundred KB and the
//   output M*K indices.  At 4,000 centers x 25,600 points that is 102 M
//   pairs, at the training shape (12 clouds x 64 centers) 19.7 M.
// Design: the TPU kernel carries count and first-winner accumulators over a
//   sequential grid of [128 centers, L] tiles; none of that carries over.
//   Here one block of 8 warps owns one center, and a warp takes one bucket
//   of L columns at a time, 32 columns a step.  A column's key is its 23-bit
//   hash noise when it lies in radius (noise + 1 in f32 is exact for 23
//   bits, so the integer orders as the TPU kernel's float does) and -1
//   otherwise; each lane keeps its best (key, column) with strict `>` while
//   walking up the bucket, and a shuffle reduction with ties to the smaller
//   column gives the bucket's first-column argmax.  A ballot counts the
//   in-radius columns.  Empty buckets take the first non-empty bucket's
//   pick in the epilogue.  The cloud (300 KB) stays in L2 across blocks, so
//   no shared-memory staging is needed.  Differences and squares are
//   rounded one by one, in the JAX order ((dx*dx + dy*dy) + dz*dz), so the
//   radius test agrees with the reference column for column.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
group_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
             uint32_t seed, int32_t* __restrict__ idx,
             int32_t* __restrict__ count, int n, int m_total, int k_total,
             int bucket, float r2) {
  extern __shared__ int s_win[];  // [K]
  __shared__ int s_cnt[kWarps];
  __shared__ int s_first;

  const int b = blockIdx.y, m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)b * m_total + m;
  xyz += (size_t)b * n * 3;
  const float cx = centers[row * 3], cy = centers[row * 3 + 1],
              cz = centers[row * 3 + 2];
  // the hash row is the center's index in its own cloud: every cloud of a
  // batch draws the same noise field, as in the TPU kernel
  const uint32_t hrow = (uint32_t)m * 0x9E3779B9u + seed;

  int cnt = 0;
  for (int k = warp; k < k_total; k += kWarps) {
    const int base = k * bucket;
    int best = -1, best_j = INT_MAX;
    for (int t0 = 0; t0 < bucket && base + t0 < n; t0 += 32) {
      const int t = t0 + lane, j = base + t;
      bool hit = false;
      if (t < bucket && j < n) {
        const float dx = __fsub_rn(cx, xyz[3 * j]);
        const float dy = __fsub_rn(cy, xyz[3 * j + 1]);
        const float dz = __fsub_rn(cz, xyz[3 * j + 2]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        hit = d2 <= r2;
      }
      if (hit) {
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
      cnt += __popc(__ballot_sync(0xffffffffu, hit));
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

// xyz [B, N, 3], centers [B, M, 3] f32, u32 seed -> idx [B, M, K] int32 (0
// where a center has no point in radius), count [B, M] int32, the exact
// in-radius population.  Bucket k covers columns [k*L, (k+1)*L); in radius
// means d2 <= r2.
extern "C" int regnet_group_regions(const float* xyz, const float* centers,
                                    uint32_t seed, int32_t* idx,
                                    int32_t* count, int batch, int n,
                                    int m_total, int k_total, int bucket,
                                    float r2, cudaStream_t stream) {
  dim3 grid(m_total, batch);
  group_kernel<<<grid, kWarps * 32, k_total * sizeof(int), stream>>>(
      xyz, centers, seed, idx, count, n, m_total, k_total, bucket, r2);
  return (int)cudaGetLastError();
}

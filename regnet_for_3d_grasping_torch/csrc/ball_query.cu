// K2 — bucketed radius query (SA1).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/ball_query_pallas.py,
//   ball_query_pallas (_bq_kernel, dispatched from ops/ball_query.py:60-65).
// Bound on the H100: arithmetic.  Each (center, point) pair costs about 9
//   flops and the inputs are small (the 300 KB cloud stays in L2), so at
//   the SA1 shape (5,120 x 25,600 pairs) the flops and the per-pair
//   compare-and-ballot instructions set the time, not memory.
// Design: one block of 8 warps per center; a warp takes one bucket of L
//   points at a time, 32 consecutive points per step.  A warp ballot gives
//   both the step's in-radius count (popc) and its first hit (ffs), so the
//   bucket's winner is the first hit of the first step that has one, with
//   no per-lane bookkeeping.  Buckets past N are skipped whole.  Counts sum
//   in shared memory; empty buckets then take the first non-empty bucket's
//   pick, and a center with no hit gets all zeros (ball_query_pallas.py:
//   181-185).  Distances are diff-squares with explicit round-to-nearest
//   intrinsics in the JAX order, so membership matches the reference.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int32_t* __restrict__ idx,
                  int32_t* __restrict__ count, int n, int m_total, int k_total,
                  int bucket, float r2) {
  extern __shared__ int s_win[];  // [K]
  __shared__ int s_cnt[kWarps];
  __shared__ int s_first;

  const int b = blockIdx.y, m = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  xyz += (size_t)b * n * 3;
  const float* c = centers + ((size_t)b * m_total + m) * 3;
  const float cx = c[0], cy = c[1], cz = c[2];

  int cnt = 0;
  for (int k = warp; k < k_total; k += kWarps) {
    const int base = k * bucket;
    int win = -1;
    for (int t0 = 0; t0 < bucket && base + t0 < n; t0 += 32) {
      const int t = t0 + lane, j = base + t;
      bool hit = false;
      if (t < bucket && j < n) {
        const float dx = __fsub_rn(xyz[3 * j], cx);
        const float dy = __fsub_rn(xyz[3 * j + 1], cy);
        const float dz = __fsub_rn(xyz[3 * j + 2], cz);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        hit = d2 < r2;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      cnt += __popc(mask);
      if (win < 0 && mask) win = base + t0 + __ffs(mask) - 1;
    }
    if (lane == 0) s_win[k] = win;
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
  const size_t row = (size_t)b * m_total + m;
  for (int k = threadIdx.x; k < k_total; k += blockDim.x)
    idx[row * k_total + k] = s_win[k] >= 0 ? s_win[k] : s_first;
  if (threadIdx.x == 0) count[row] = total < k_total ? total : k_total;
}

}  // namespace

// xyz [B, N, 3], centers [B, M, 3] f32 -> idx [B, M, K], count [B, M]
// int32.  Bucket k covers point indices [k*L, (k+1)*L).
extern "C" int regnet_ball_query(const float* xyz, const float* centers,
                                 int32_t* idx, int32_t* count, int batch,
                                 int n, int m_total, int k_total, int bucket,
                                 float r2, cudaStream_t stream) {
  dim3 grid(m_total, batch);
  ball_query_kernel<<<grid, kWarps * 32, k_total * sizeof(int), stream>>>(
      xyz, centers, idx, count, n, m_total, k_total, bucket, r2);
  return (int)cudaGetLastError();
}

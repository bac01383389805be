// K1 — masked iterative farthest point sampling, and K10 — its grouped
// (stratified) form.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/fps_pallas.py, fps_pallas
//   (_fps_kernel_v2, dispatched from ops/fps.py:134) and fps_pallas_grouped
//   (_fps_kernel_grouped, fps_pallas.py:211, dispatched from ops/fps.py:119).
// Bound on the H100: latency.  The S steps depend on each other; each is a
//   pass over the N-point distance field plus a block-wide argmax, so the
//   work is tiny (about 10 flops per point and step) but runs on one SM per
//   batch element, with two barriers per step.
// Design: one block of 1024 threads per batch element loops over S inside
//   the kernel.  The running distance field (N floats, 100 KB at N=25600)
//   stays in shared memory for the whole loop; the coordinates (300 KB, too
//   big for shared memory beside it) are read through L1/L2.  The argmax is
//   a warp shuffle reduction plus one warp over the per-warp winners, ties
//   going to the smaller index.  Distances are diff-squares summed as
//   ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest intrinsics, the
//   JAX order, so every pick is bit-identical to the reference.
//   Using one SM is the known weakness (a later change can split the field
//   across a cluster).
//   Grouped: G independent exact runs of S/G samples over the G contiguous
//   slices of N/G points.  The TPU kernel advances all slices in one program
//   because a TPU core runs one program at a time; here each (batch, slice)
//   is a thread block of its own running the same loop on its slice, so the
//   slices run on G SMs at once and the dependent steps drop from S to S/G.
//   Indices come out slice-major with the slice's offset g*N/G added.  The
//   kernel is a template on `kGrouped` only so that a profile names the two
//   forms apart (fps_kernel<false> is K1, fps_kernel<true> is K10).

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// First-index argmax over the block; every thread gets the winner.
__device__ int block_argmax(float v, int i, float* sv, int* si, int* sout) {
  for (int off = 16; off > 0; off >>= 1)
    take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                __shfl_down_sync(0xffffffffu, i, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, i, off));
    if (lane == 0) *sout = i;
  }
  __syncthreads();
  return *sout;
}

template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const float* __restrict__ dist_init,
           int32_t* __restrict__ out, int n, int s_total, int groups) {
  extern __shared__ float dist[];
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int sfar;

  // block = (batch element, slice): a slice is n points, s_total samples
  const int b = blockIdx.x;
  const int offset = kGrouped ? (b % groups) * n : 0;
  xyz += (size_t)b * n * 3;
  dist_init += (size_t)b * n;
  out += (size_t)b * s_total;

  // start: first-index argmax of the sentinel field (1e10 valid, -1 masked)
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float d = dist_init[j];
    dist[j] = d;
    if (d > bv) {
      bv = d;
      bi = j;
    }
  }
  int far = block_argmax(bv, bi, sv, si, &sfar);

  for (int s = 0; s < s_total; ++s) {
    if (threadIdx.x == 0) out[s] = far + offset;
    if (s + 1 == s_total) break;
    const float cx = xyz[3 * far], cy = xyz[3 * far + 1],
                cz = xyz[3 * far + 2];
    bv = -INFINITY;
    bi = INT_MAX;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float dx = __fsub_rn(xyz[3 * j], cx);
      const float dy = __fsub_rn(xyz[3 * j + 1], cy);
      const float dz = __fsub_rn(xyz[3 * j + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      float cur = dist[j];
      if (!(cur < 0.f)) {
        cur = d < cur ? d : cur;
        dist[j] = cur;
      }
      if (cur > bv) {
        bv = cur;
        bi = j;
      }
    }
    far = block_argmax(bv, bi, sv, si, &sfar);
  }
}

template <bool kGrouped>
int launch(const float* xyz, const float* dist_init, int32_t* out, int blocks,
           int n, int s_total, int groups, cudaStream_t stream) {
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<kGrouped>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<kGrouped><<<blocks, kThreads, smem, stream>>>(
      xyz, dist_init, out, n, s_total, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz [B, N, 3] f32, dist_init [B, N] f32 -> out [B, S] int32.
extern "C" int regnet_fps(const float* xyz, const float* dist_init,
                          int32_t* out, int batch, int n, int s_total,
                          cudaStream_t stream) {
  return launch<false>(xyz, dist_init, out, batch, n, s_total, 1, stream);
}

// Grouped: xyz [B, N, 3], dist_init [B, N] (each slice's own sentinel
// field), N and S multiples of `groups` -> out [B, S] int32, slice-major:
// out[b, g*S/G + i] = g*N/G + (i-th pick of slice g).
extern "C" int regnet_fps_grouped(const float* xyz, const float* dist_init,
                                  int32_t* out, int batch, int n, int s_total,
                                  int groups, cudaStream_t stream) {
  return launch<true>(xyz, dist_init, out, batch * groups, n / groups,
                      s_total / groups, groups, stream);
}

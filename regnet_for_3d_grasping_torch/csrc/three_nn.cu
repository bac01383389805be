// K3 — three nearest neighbours (FP3).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/knn_pallas.py, three_nn_pallas
//   (_knn_kernel, version 1, dispatched from ops/knn.py:52).
// Bound on the H100: arithmetic.  At the FP3 shape every one of 25,600
//   queries meets every one of 5,120 keys (131 M pairs a cloud) over inputs
//   of a few hundred KB.  An exact scan needs dx, its square and a compare
//   (3 operations) on every pair, since the rounded sum of squares is at
//   least dx*dx and a pair whose dx*dx reaches the query's third distance
//   cannot enter; only the other pairs need dy, dz, their squares, two adds
//   and the compare with the third distance (7 more).
// Design: the keys are split into S ranges in index order, and a block of
//   128 threads owns a tile of 128*Q queries x one range, Q queries a
//   thread with their running best three (distance, index) in registers;
//   Q and S come from the pure rule ops/knn.split_grid, which fills the
//   card with as few ranges as it can (the kernel this replaced ran 100
//   blocks of one query a thread on 132 SMs at batch 1; the rule gives 4
//   ranges of one query a thread there, 800 blocks, one range of two at
//   batch 12, and 6 ranges on the slab fallback's x-sorted keys).  The
//   scan of a range is `three_nn::scan_keys` (three_nn.cuh), which K8
//   shares: keys staged as float4, 4-key batched insertion tests (a
//   compare and a branch on every pair, or dy and dz only where dx*dx
//   stays under the third distance, ran slower; see PERF.md), strict `<`
//   in ascending key order.  With one range the block writes the result;
//   otherwise it writes its range's three (a placeholder (3e38, 0) where
//   the range holds fewer keys) and a merge launch, one thread per query,
//   inserts the S lists in range order with the same strict compares:
//   ranges ascend in index, so the merge keeps what one scan in index
//   order keeps, the three smallest by (distance, index), ascending, as in
//   the TPU kernel.
//   As the slab 3-NN's fallback (K8's certificate failed), both launches
//   take K8's device flag and return at once where it is 0, so the host
//   never reads the certificate; where it is 1 they overwrite K8's output.

#include <cuda_runtime.h>
#include <cstdint>

#include "three_nn.cuh"

namespace {

using three_nn::Best3;
using three_nn::kMaxPerThread;
using three_nn::kThreads;

constexpr int kMergeThreads = 256;
constexpr float kInf = 3e38f;     // the TPU kernel's "no neighbour" distance

// query [B, N1, 3] x keys [r*span, min((r+1)*span, N2)) of range r.  With
// one range the three go to out [B, N1, 3]; otherwise to out [B, S, 3, N1]
// (coalesced for the merge).  Nothing runs where `fallback` is given and
// holds 0.
template <int Q>
__global__ void __launch_bounds__(kThreads)
three_nn_split_kernel(const float* __restrict__ query,
                      const float* __restrict__ key, int32_t* __restrict__ idx,
                      float* __restrict__ dist, int n1, int n2, int span,
                      int nranges, const int32_t* __restrict__ fallback) {
  if (fallback && *fallback == 0) return;
  __shared__ float4 sk[three_nn::kChunk];
  const int b = blockIdx.y;
  const int tile = blockIdx.x / nranges, r = blockIdx.x % nranges;
  const int q0 = tile * Q * kThreads + threadIdx.x;
  query += (size_t)b * n1 * 3;
  key += (size_t)b * n2 * 3;
  float qx[Q], qy[Q], qz[Q];
  Best3 best[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    // a query past the end is scanned as a copy of the last, unwritten
    const int q = min(q0 + u * kThreads, n1 - 1);
    qx[u] = query[3 * q];
    qy[u] = query[3 * q + 1];
    qz[u] = query[3 * q + 2];
    best[u].init(kInf);
  }
  const int k0 = r * span, k1 = min(n2, k0 + span);
  three_nn::scan_keys<Q>(sk, key, k0, k1, qx, qy, qz, best);
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int q = q0 + u * kThreads;
    if (q >= n1) continue;
    if (nranges == 1)
      three_nn::put_part(idx, dist, ((size_t)b * n1 + q) * 3, 1, best[u]);
    else
      three_nn::put_part(idx, dist, ((size_t)b * nranges + r) * 3 * n1 + q,
                         n1, best[u]);
  }
}

// The S ranges' threes [B, S, 3, N1] -> idx, dist [B, N1, 3], one thread a
// query, inserted in range order.
__global__ void __launch_bounds__(kMergeThreads)
three_nn_merge_kernel(const int32_t* __restrict__ pidx,
                      const float* __restrict__ pdist,
                      int32_t* __restrict__ idx, float* __restrict__ dist,
                      int n1, int nranges,
                      const int32_t* __restrict__ fallback) {
  if (fallback && *fallback == 0) return;
  const int b = blockIdx.y, q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= n1) return;
  Best3 t;
  t.init(kInf);
  // unrolled so that several ranges' loads are in flight at once
#pragma unroll 4
  for (int r = 0; r < nranges; ++r) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const size_t o = (((size_t)b * nranges + r) * 3 + e) * n1 + q;
      t.insert(pdist[o], pidx[o]);
    }
  }
  three_nn::put_part(idx, dist, ((size_t)b * n1 + q) * 3, 1, t);
}

template <int Q>
void split(dim3 grid, cudaStream_t stream, const float* query,
           const float* key, int32_t* idx, float* dist, int n1, int n2,
           int span, int nranges, const int32_t* fallback) {
  three_nn_split_kernel<Q><<<grid, kThreads, 0, stream>>>(
      query, key, idx, dist, n1, n2, span, nranges, fallback);
}

}  // namespace

// query [B, N1, 3], key [B, N2, 3] f32 -> idx [B, N1, 3] int32, dist
// [B, N1, 3] f32 squared distances, ascending.  `per_thread` queries a
// thread (1 or 2) and `ranges` key ranges of ceil(N2 / ranges) keys
// (ops/knn.split_grid); with more than one range, part_idx / part_dist
// [B, ranges, 3, N1] are the split's scratch and a merge launch follows.
// `fallback` (may be null): a device int32; where it holds 0 both launches
// return at once and idx / dist keep what they held.
// cudaErrorInvalidValue for a grid the kernel does not take.
extern "C" int regnet_three_nn(const float* query, const float* key,
                               int32_t* idx, float* dist, int32_t* part_idx,
                               float* part_dist, const int32_t* fallback,
                               int batch, int n1, int n2, int per_thread,
                               int ranges, cudaStream_t stream) {
  if (batch < 1 || n1 < 1 || n2 < 1 || ranges < 1 || ranges > n2 ||
      (per_thread != 1 && per_thread != kMaxPerThread) ||
      (ranges > 1 && (!part_idx || !part_dist)))
    return (int)cudaErrorInvalidValue;
  const int span = (n2 + ranges - 1) / ranges;
  const int tiles = (n1 + kThreads * per_thread - 1) / (kThreads * per_thread);
  const dim3 grid(tiles * ranges, batch);
  int32_t* oi = ranges == 1 ? idx : part_idx;
  float* od = ranges == 1 ? dist : part_dist;
  if (per_thread == 1)
    split<1>(grid, stream, query, key, oi, od, n1, n2, span, ranges,
             fallback);
  else
    split<kMaxPerThread>(grid, stream, query, key, oi, od, n1, n2, span,
                         ranges, fallback);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return (int)err;
  const dim3 mgrid((n1 + kMergeThreads - 1) / kMergeThreads, batch);
  three_nn_merge_kernel<<<mgrid, kMergeThreads, 0, stream>>>(
      part_idx, part_dist, idx, dist, n1, ranges, fallback);
  return (int)cudaGetLastError();
}

// The kernel's constants that ops/knn.split_grid needs: threads a block and
// the most queries a thread.  They launch nothing.
extern "C" int regnet_three_nn_threads() { return kThreads; }
extern "C" int regnet_three_nn_max_per_thread() { return kMaxPerThread; }

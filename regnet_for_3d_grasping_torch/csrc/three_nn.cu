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
//   block stages its range's keys in shared memory as
//   padded float4, so a key costs one 16-byte broadcast load per warp for
//   Q independent distance chains.  A thread tests kStep keys at once
//   against its third distances and branches to the insertions only where
//   one of them enters (a compare and a branch on every pair, or dy and dz
//   only where dx*dx stays under the third distance, ran slower; see
//   PERF.md).  Each thread inserts with strict `<` compares in ascending
//   key order, so among equal distances the smaller index stays ahead.  With one range the block writes the
//   result; otherwise it writes its range's three (a placeholder (3e38, 0)
//   where the range holds fewer keys) and a merge launch, one thread per
//   query, inserts the S lists in range order with the same strict
//   compares: ranges ascend in index, so the merge keeps what one scan in
//   index order keeps, the three smallest by (distance, index), ascending,
//   as in the TPU kernel.  Distances are diff-squares with explicit
//   round-to-nearest intrinsics in the JAX order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPerThread = 2;  // Q: 1 or 2 queries a thread
constexpr int kChunk = 1024;      // keys a block stages at a time, 16 KB
constexpr int kMergeThreads = 256;
constexpr float kInf = 3e38f;     // the TPU kernel's "no neighbour" distance

// A query's best three (distance, index), ascending.
struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;
  __device__ __forceinline__ void init() {
    d0 = d1 = d2 = kInf;
    i0 = i1 = i2 = 0;
  }
  // strict compares: an equal distance met later (a larger index) stays
  // behind
  __device__ __forceinline__ void insert(float d, int j) {
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
};

// A step of kStep keys computes the Q x kStep distances, ORs their
// compares with the third distances into one predicate, and inserts, pair
// by pair in key order, only where it holds: the compares come before any
// insertion, but an insertion only lowers the third distance, so a pair
// that fails against the step's first one fails against every later one.
constexpr int kStep = 4;

__device__ __forceinline__ float dist2(const float4& k, float qx, float qy,
                                       float qz) {
  const float dx = __fsub_rn(k.x, qx), dy = __fsub_rn(k.y, qy),
              dz = __fsub_rn(k.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// query [B, N1, 3] x keys [r*span, min((r+1)*span, N2)) of range r.  With
// one range the three go to out [B, N1, 3]; otherwise to out [B, S, 3, N1]
// (coalesced for the merge).
template <int Q>
__global__ void __launch_bounds__(kThreads)
three_nn_split_kernel(const float* __restrict__ query,
                      const float* __restrict__ key, int32_t* __restrict__ idx,
                      float* __restrict__ dist, int n1, int n2, int span,
                      int nranges) {
  __shared__ float4 sk[kChunk];
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
    best[u].init();
  }
  const int k0 = r * span, k1 = min(n2, k0 + span);
  for (int base = k0; base < k1; base += kChunk) {
    const int len = min(kChunk, k1 - base);
    // NaN keys up to a whole step: a NaN distance never enters
    const int padded = (len + kStep - 1) / kStep * kStep;
    __syncthreads();
    for (int s = threadIdx.x; s < padded; s += kThreads) {
      const float* p = key + 3 * (size_t)(base + s);
      sk[s] = s < len ? make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f)
                      : make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int s = 0; s < padded; s += kStep) {
      float d[kStep][Q];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kStep; ++i) {
        const float4 k = sk[s + i];
#pragma unroll
        for (int u = 0; u < Q; ++u) {
          d[i][u] = dist2(k, qx[u], qy[u], qz[u]);
          any |= d[i][u] < best[u].d2;
        }
      }
      if (any) {
#pragma unroll
        for (int i = 0; i < kStep; ++i)
#pragma unroll
          for (int u = 0; u < Q; ++u) best[u].insert(d[i][u], base + s + i);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int q = q0 + u * kThreads;
    if (q >= n1) continue;
    const Best3& t = best[u];
    if (nranges == 1) {
      const size_t o = ((size_t)b * n1 + q) * 3;
      idx[o] = t.i0;
      idx[o + 1] = t.i1;
      idx[o + 2] = t.i2;
      dist[o] = t.d0;
      dist[o + 1] = t.d1;
      dist[o + 2] = t.d2;
    } else {
      const size_t o = ((size_t)b * nranges + r) * 3 * n1 + q;
      idx[o] = t.i0;
      idx[o + n1] = t.i1;
      idx[o + 2 * (size_t)n1] = t.i2;
      dist[o] = t.d0;
      dist[o + n1] = t.d1;
      dist[o + 2 * (size_t)n1] = t.d2;
    }
  }
}

// The S ranges' threes [B, S, 3, N1] -> idx, dist [B, N1, 3], one thread a
// query, inserted in range order.
__global__ void __launch_bounds__(kMergeThreads)
three_nn_merge_kernel(const int32_t* __restrict__ pidx,
                      const float* __restrict__ pdist,
                      int32_t* __restrict__ idx, float* __restrict__ dist,
                      int n1, int nranges) {
  const int b = blockIdx.y, q = blockIdx.x * kMergeThreads + threadIdx.x;
  if (q >= n1) return;
  Best3 t;
  t.init();
  // unrolled so that several ranges' loads are in flight at once
#pragma unroll 4
  for (int r = 0; r < nranges; ++r) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const size_t o = (((size_t)b * nranges + r) * 3 + e) * n1 + q;
      t.insert(pdist[o], pidx[o]);
    }
  }
  const size_t o = ((size_t)b * n1 + q) * 3;
  idx[o] = t.i0;
  idx[o + 1] = t.i1;
  idx[o + 2] = t.i2;
  dist[o] = t.d0;
  dist[o + 1] = t.d1;
  dist[o + 2] = t.d2;
}

template <int Q>
void split(dim3 grid, cudaStream_t stream, const float* query,
           const float* key, int32_t* idx, float* dist, int n1, int n2,
           int span, int nranges) {
  three_nn_split_kernel<Q><<<grid, kThreads, 0, stream>>>(
      query, key, idx, dist, n1, n2, span, nranges);
}

}  // namespace

// query [B, N1, 3], key [B, N2, 3] f32 -> idx [B, N1, 3] int32, dist
// [B, N1, 3] f32 squared distances, ascending.  `per_thread` queries a
// thread (1 or 2) and `ranges` key ranges of ceil(N2 / ranges) keys
// (ops/knn.split_grid); with more than one range, part_idx / part_dist
// [B, ranges, 3, N1] are the split's scratch and a merge launch follows.
// cudaErrorInvalidValue for a grid the kernel does not take.
extern "C" int regnet_three_nn(const float* query, const float* key,
                               int32_t* idx, float* dist, int32_t* part_idx,
                               float* part_dist, int batch, int n1, int n2,
                               int per_thread, int ranges,
                               cudaStream_t stream) {
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
    split<1>(grid, stream, query, key, oi, od, n1, n2, span, ranges);
  else
    split<kMaxPerThread>(grid, stream, query, key, oi, od, n1, n2, span,
                         ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return (int)err;
  const dim3 mgrid((n1 + kMergeThreads - 1) / kMergeThreads, batch);
  three_nn_merge_kernel<<<mgrid, kMergeThreads, 0, stream>>>(
      part_idx, part_dist, idx, dist, n1, ranges);
  return (int)cudaGetLastError();
}

// The kernel's constants that ops/knn.split_grid needs: threads a block and
// the most queries a thread.  They launch nothing.
extern "C" int regnet_three_nn_threads() { return kThreads; }
extern "C" int regnet_three_nn_max_per_thread() { return kMaxPerThread; }

// The 3-NN scan that K3 (three_nn.cu) and K8 (three_nn_slab.cu) share:
// a block of kThreads threads, Q queries a thread, scans one range of keys
// in index order and keeps each query's best three (distance, index).
//
// The block stages the range's keys in shared memory as padded float4, so
// a key costs one 16-byte broadcast load per warp for Q independent
// distance chains.  A thread tests kStep keys at once against its third
// distances and branches to the insertions only where one of them enters.
// Each thread inserts with strict `<` compares in ascending key order, so
// among equal distances the smaller index stays ahead; lists of ranges
// that ascend in index, merged in range order with the same compares, keep
// what one scan in index order keeps.  Distances are diff-squares with
// explicit round-to-nearest intrinsics in the JAX order.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace three_nn {

constexpr int kThreads = 128;
constexpr int kMaxPerThread = 2;  // Q: 1 or 2 queries a thread
constexpr int kChunk = 1024;      // keys a block stages at a time, 16 KB
// A step of kStep keys computes the Q x kStep distances, ORs their
// compares with the third distances into one predicate, and inserts, pair
// by pair in key order, only where it holds: the compares come before any
// insertion, but an insertion only lowers the third distance, so a pair
// that fails against the step's first one fails against every later one.
constexpr int kStep = 4;

// A query's best three (distance, index), ascending.
struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;
  __device__ __forceinline__ void init(float empty) {
    d0 = d1 = d2 = empty;
    i0 = i1 = i2 = 0;
  }
  // for a key whose index is below every index held: an equal distance
  // goes ahead; a distance of `empty` or more never enters
  __device__ __forceinline__ void insert_below(float d, int j, float empty) {
    if (!(d < empty) || !(d <= d2)) return;
    if (d <= d1) {
      d2 = d1;
      i2 = i1;
      if (d <= d0) {
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

__device__ __forceinline__ float dist2(const float4& k, float qx, float qy,
                                       float qz) {
  const float dx = __fsub_rn(k.x, qx), dy = __fsub_rn(k.y, qy),
              dz = __fsub_rn(k.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The block's Q queries a thread (loaded by the caller) against keys
// [k0, k1) of `key` [N, 3], staged through `sk` [kChunk]; inserts into
// `best`.  Every thread of the block calls it (it syncs the block).
template <int Q>
__device__ __forceinline__ void scan_keys(float4* sk,
                                          const float* __restrict__ key,
                                          int k0, int k1, const float* qx,
                                          const float* qy, const float* qz,
                                          Best3* best) {
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
}

// K8's variant: keys [k0, k1), at most kChunk of them, staged in index
// order at sk[kStep ..] (sk holds kChunk + 2 kStep) with NaN keys around
// them, walked outward from the first key whose x is not below `pivot`
// (the keys are sorted in x, so a query meets its neighbours first and
// inserts little after them): up from there with `insert`, then down from
// the key before it with `insert_below`, which puts an equal distance at a
// smaller index ahead.  The result is the three smallest (distance, index)
// pairs, as the walk in index order gives; empty slots hold (`empty`, 0).
// Every thread of the block calls it (it syncs the block).
template <int Q>
__device__ __forceinline__ void scan_keys_outward(
    float4* sk, const float* __restrict__ key, int k0, int k1, float pivot,
    float empty, const float* qx, const float* qy, const float* qz,
    Best3* best) {
  const int len = max(k1 - k0, 0);
  const float4 nan4 = make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
  __syncthreads();
  // a step reads up to kStep - 1 keys past either end: NaN keys there
  for (int s = threadIdx.x; s < len + 2 * kStep; s += kThreads) {
    const float* p = key + 3 * (size_t)(k0 + s - kStep);
    sk[s] = s >= kStep && s < len + kStep
                ? make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f)
                : nan4;
  }
  __syncthreads();
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[kStep + mid].x < pivot) lo = mid + 1;
    else hi = mid;
  }
  for (int s = lo; s < len; s += kStep) {  // up, ascending
    float d[kStep][Q];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      const float4 k = sk[kStep + s + i];
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
        for (int u = 0; u < Q; ++u) best[u].insert(d[i][u], k0 + s + i);
    }
  }
  for (int s = lo - 1; s >= 0; s -= kStep) {  // down, descending
    float d[kStep][Q];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      const float4 k = sk[kStep + s - i];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        d[i][u] = dist2(k, qx[u], qy[u], qz[u]);
        any |= d[i][u] <= best[u].d2;
      }
    }
    if (any) {
#pragma unroll
      for (int i = 0; i < kStep; ++i)
#pragma unroll
        for (int u = 0; u < Q; ++u)
          best[u].insert_below(d[i][u], k0 + s - i, empty);
    }
  }
}

// Write a query's three to the [.., 3, n] layout a merge reads
// (coalesced over queries) at `o`, stride `n`.
__device__ __forceinline__ void put_part(int32_t* idx, float* dist, size_t o,
                                         size_t n, const Best3& t) {
  idx[o] = t.i0;
  idx[o + n] = t.i1;
  idx[o + 2 * n] = t.i2;
  dist[o] = t.d0;
  dist[o + n] = t.d1;
  dist[o + 2 * n] = t.d2;
}

}  // namespace three_nn

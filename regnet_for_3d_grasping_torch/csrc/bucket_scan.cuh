// The center-tiled bucket scan shared by K11 (group.cu) and K5 (crop.cu):
// for each center m and bucket k of L columns, the passing column with the
// largest 23-bit counter-hash score (the first column on ties), -1 where
// none passes, and the exact count of passing columns over all buckets;
// empty buckets then take the first non-empty bucket's pick, and a center
// with no passing column gets all zeros.  The test (which columns pass for
// a center) and the pick rule (which passing column a bucket keeps) are
// template parameters.
//
// Bound on the H100: arithmetic.  Every (center, column) pair costs the
// first row of its test (K11: dx and its square against r2, 3 operations;
// K5: the frame's z row and its slab, 10), only a pair inside that slab
// the rest, and only a pair that passes its hash and a place in the
// bucket's argmax (group.cu and crop.cu count them).  The cloud is 300 KB,
// so neither L2 nor device memory is the limit once each block reads it
// once per tile of centers.
//
// Design, two launches and no host sync:
//   1. bucket_scan_kernel<Test, Pick>: a block of 8 warps owns a tile of
//      centers (C per warp, their test parameters in registers) x a range
//      of buckets, the grid's `tile` and `range` picked by
//      ops/bucket_scan.scan_grid.  It stages the range's columns once into
//      shared memory as SoA x/y/z with coalesced 16-byte loads (NaN past N,
//      which no test passes), so the cloud crosses L2 once per tile, not
//      once per center.  A lane reads a column once and tests it against
//      each of its warp's C centers, keeping one hit bit per (center,
//      32-column step) of the bucket: 8 + 2 instructions per pair for K11's
//      radius.  At the end of a bucket one vote asks whether any lane hit
//      for any of the C centers; at the serving shapes most buckets have
//      none, and then the warp only writes -1 for its C slots.  Otherwise each center with a hit
//      counts its bits, computes the hash of its hit columns alone and
//      packs (score, place) into a key whose warp-wide maximum (two
//      `redux.sync`) is the pick.  Each (center, bucket) slot has one
//      owner block, which writes its pick or -1 (lane c for center c); the
//      block's counts go out as one partial per (center, range).  Buckets
//      past N are never scanned.
//   2. bucket_fill_kernel, a warp per center: the partial counts summed
//      (exact), the first pick in bucket order found by a ballot, and every
//      empty or never-scanned slot filled with it (0 when there is none).
// The per-pair arithmetic rounds as the JAX reference does (the tests use
// explicit round-to-nearest intrinsics; the build passes -fmad=false), and
// the hash is the TPU kernel's in uint32, so the picks are the JAX
// package's picks.  A Test also fixes C, the steps a lane unrolls and the
// blocks an SM must hold (the register budget).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace bucket_scan {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 64;  // centers per block
// columns a block stages: 42 KB of SoA, under the 48 KB a block may use
// without opting in (read by ops/bucket_scan through each source's
// regnet_<kernel>_stage_cols)
constexpr int kMaxStageCols = 3584;

// Uniform parameters of a test (the radius, or the box).
struct Params {
  float v[4];
};

// The TPU kernels' counter hash, top 23 bits: keyed by the center's row in
// its own cloud and the column (group_pallas.py:57-66, crop_pallas.py:70-80).
__device__ __forceinline__ uint32_t hash23(int m, uint32_t seed, int j) {
  uint32_t h = ((uint32_t)m * 0x9E3779B9u + seed) + (uint32_t)j * 2654435761u;
  h ^= h >> 16;
  h *= 0x45D9F3Bu;
  h ^= h >> 16;
  return h >> 9;
}

// The hash pick: the largest score, ties to the first column of the
// bucket.  A lane packs each hit into a 64-bit key, (score + 1) over the
// complement of its place `rel` in the bucket, so that the max of the keys
// is the pick and 0 means no hit; the warp reduces the high word, then the
// low word of the lanes that hold the high word's maximum.
struct HashPick {
  using Key = uint64_t;
  static __device__ __forceinline__ Key key(uint32_t score, int rel) {
    return ((uint64_t)(score + 1u) << 32) | (uint32_t)(0xFFFFFFFFu - rel);
  }
  // the place of the warp's largest key (some lane holds a nonzero one)
  static __device__ __forceinline__ int warp_rel(Key k) {
    const uint32_t hi = (uint32_t)(k >> 32);
    const uint32_t top = __reduce_max_sync(0xffffffffu, hi);
    const uint32_t lo =
        __reduce_max_sync(0xffffffffu, hi == top ? (uint32_t)k : 0u);
    return (int)(0xFFFFFFFFu - lo);
  }
};

// columns [col0, col0 + cols) of one cloud (AoS) -> s[3][stride] (SoA),
// and NaN in columns [cols, pad): no test passes a NaN column, so a bucket
// cut at N needs no bounds check
__device__ __forceinline__ void stage(const float* __restrict__ xyz, int col0,
                                      int cols, int pad, int stride,
                                      float* s) {
  const float* src = xyz + (size_t)col0 * 3;
  const int nf = cols * 3;
  int f0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = nf / 4;
    for (int t = threadIdx.x; t < n4; t += kThreads) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + t);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 4 * t + i;
        s[(f % 3) * stride + f / 3] = e[i];
      }
    }
    f0 = n4 * 4;
  }
  for (int f = f0 + threadIdx.x; f < nf; f += kThreads)
    s[(f % 3) * stride + f / 3] = __ldg(src + f);
  for (int u = cols + threadIdx.x; u < pad; u += kThreads)
    s[u] = s[stride + u] = s[2 * stride + u] = __int_as_float(0x7fc00000);
}

template <class Test, class Pick>
__global__ void __launch_bounds__(kThreads, Test::kMinBlocks)
bucket_scan_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ frames,
                   const float* __restrict__ centers, uint32_t seed,
                   int32_t* __restrict__ idx, int32_t* __restrict__ partial,
                   int n, int m_total, int k_total, int bucket, int tile,
                   int range, int nranges, Params p) {
  constexpr int C = Test::kPerWarp;
  extern __shared__ float s_pts[];  // [3][range * bucket]
  __shared__ int s_cnt[kMaxTile];

  const int b = blockIdx.y;
  const int t_id = blockIdx.x / nranges, r_id = blockIdx.x % nranges;
  const int stride = range * bucket;
  const int col0 = r_id * stride;
  const int cols = min(stride, n - col0);
  const int nbk = (cols + bucket - 1) / bucket;
  const int per_group = kWarps / (tile / C);  // warps sharing C centers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = warp % per_group;
  const int m0 = t_id * tile + (warp / per_group) * C;

  if (threadIdx.x < tile) s_cnt[threadIdx.x] = 0;
  stage(xyz + (size_t)b * n * 3, col0, cols, nbk * bucket, stride, s_pts);
  __syncthreads();

  if (m0 < m_total) {
    Test test[C];
    int cnt[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // a center past the end is scanned as a copy of the last, unwritten
      test[c].load(frames, centers,
                   (size_t)b * m_total + min(m0 + c, m_total - 1));
      cnt[c] = 0;
    }
    // lane c < C writes center c's slot of each bucket
    int32_t* out = idx + ((size_t)b * m_total + m0 + lane) * k_total +
                   col0 / bucket;
    const bool writes = lane < C && m0 + lane < m_total;
    for (int kk = sub; kk < nbk; kk += per_group) {
      const float* pts = s_pts + kk * bucket + lane;
      uint32_t hits[C];
#pragma unroll
      for (int c = 0; c < C; ++c) hits[c] = 0;
      constexpr int kUnroll = Test::kUnroll;
#pragma unroll kUnroll
      for (int s = 0; s < bucket / 32; ++s) {
        const float x = pts[32 * s], y = pts[stride + 32 * s],
                    z = pts[2 * stride + 32 * s];
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (test[c](x, y, z, p)) hits[c] |= 1u << s;
      }
      uint32_t any = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) any |= hits[c];
      int pick = -1;
      if (__any_sync(0xffffffffu, any)) {  // else no center of the warp hit
        const int col = col0 + kk * bucket;  // the bucket's first column
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!__any_sync(0xffffffffu, hits[c])) continue;
          cnt[c] += __popc(hits[c]);
          typename Pick::Key best = 0;
          for (uint32_t h = hits[c]; h; h &= h - 1) {
            const int rel = (__ffs(h) - 1) * 32 + lane;
            const auto key = Pick::key(hash23(m0 + c, seed, col + rel), rel);
            best = key > best ? key : best;
          }
          const int win = col + Pick::warp_rel(best);
          if (lane == c) pick = win;
        }
      }
      if (writes) out[kk] = pick;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int total = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt[c]);
      if (lane == 0) atomicAdd(&s_cnt[(warp / per_group) * C + c], total);
    }
  }
  __syncthreads();
  const int m = t_id * tile + threadIdx.x;
  if (threadIdx.x < tile && m < m_total)
    partial[((size_t)b * m_total + m) * nranges + r_id] = s_cnt[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
bucket_fill_kernel(int32_t* __restrict__ idx,
                   const int32_t* __restrict__ partial,
                   int32_t* __restrict__ count, int rows, int k_total, int nb,
                   int nranges) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  int c = 0;
  for (int j = lane; j < nranges; j += 32) c += partial[(size_t)r * nranges + j];
  c = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
  int32_t* row = idx + (size_t)r * k_total;
  int first = -1;
  for (int k0 = 0; k0 < nb && first < 0; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < nb ? row[k] : -1;
    const unsigned has = __ballot_sync(0xffffffffu, v >= 0);
    if (has) first = __shfl_sync(0xffffffffu, v, __ffs(has) - 1);
  }
  const int fill = first < 0 ? 0 : first;
  for (int k = lane; k < k_total; k += 32)
    if (k >= nb || row[k] < 0) row[k] = fill;
  if (lane == 0) count[r] = c;
}

// Both launches on `stream`; cudaErrorInvalidValue for a grid the kernel
// does not take (ops/bucket_scan.scan_grid gives only ones it takes).
template <class Test>
int launch(const float* xyz, const float* frames, const float* centers,
           uint32_t seed, int32_t* idx, int32_t* count, int32_t* partial,
           int batch, int n, int m_total, int k_total, int bucket, int tile,
           int range, Params p, cudaStream_t stream) {
  constexpr int C = Test::kPerWarp;
  if (batch < 1 || n < 1 || m_total < 1 || bucket < 32 || bucket % 32 ||
      bucket > 32 * 32 || (long long)k_total * bucket < n || tile < C ||
      tile > kMaxTile || tile % C || kWarps % (tile / C) || range < 1 ||
      range * bucket > kMaxStageCols)
    return (int)cudaErrorInvalidValue;
  const int nb = (n + bucket - 1) / bucket;
  const int nranges = (nb + range - 1) / range;
  const int tiles = (m_total + tile - 1) / tile;
  const dim3 grid(tiles * nranges, batch);
  const size_t smem = 3 * (size_t)range * bucket * sizeof(float);
  bucket_scan_kernel<Test, HashPick><<<grid, kThreads, smem, stream>>>(
      xyz, frames, centers, seed, idx, partial, n, m_total, k_total, bucket,
      tile, range, nranges, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = batch * m_total;
  bucket_fill_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      idx, partial, count, rows, k_total, nb, nranges);
  return (int)cudaGetLastError();
}

}  // namespace bucket_scan

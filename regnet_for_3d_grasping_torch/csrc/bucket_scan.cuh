// The center-tiled bucket scan shared by K11 (group.cu), K5 (crop.cu) and
// K2 (ball_query.cu): for each center m and bucket k of L columns, the
// column that the Pick keeps among the columns that pass the Test (K11,
// K5: the largest 23-bit counter-hash score, the first column on ties; K2:
// the first column), -1 where none passes, and the count of passing
// columns over all buckets, capped at `cap` (K2: K; K11, K5: exact); empty
// buckets then take the first non-empty bucket's pick, and a center with no
// passing column gets all zeros.  The test (which columns pass for a
// center) and the pick (which passing column a bucket keeps, and the score
// it needs) are template parameters.
//
// Bound on the H100: arithmetic.  Every (center, column) pair costs the
// first row of its test (K11, K2: dx and its square against r2, 3
// operations; K5: the frame's z row and its slab, 10), only a pair inside
// that slab the rest, and only a pair that passes its pick's work (K11,
// K5: the hash and a place in the bucket's argmax; K2: its count and a
// place in the bucket's minimum; ball_query.cu, group.cu and crop.cu count
// them).  The cloud is 300 KB, so neither L2 nor device memory is the limit
// once each block reads it once per tile of centers.
//
// Design, two launches and no host sync:
//   1. bucket_scan_kernel<Test, Pick, kWide>: a block of 8 warps owns a
//      tile of centers (C per warp, their test parameters in registers) x
//      a range of buckets, the grid's `tile` and `range` picked by
//      ops/bucket_scan.scan_grid.  It stages the range's columns once into
//      shared memory as SoA x/y/z with coalesced 16-byte loads (NaN past N,
//      which no test passes), so the cloud crosses L2 once per tile, not
//      once per center.  A lane reads a column once and tests it against
//      each of its warp's C centers, keeping one hit bit per (center,
//      32-column step) of a segment, 1,024 columns at most (L is a
//      multiple of 32, so each bucket starts a step).  At the end of a
//      segment one vote asks whether any lane hit for any of the C
//      centers; at the serving shapes most buckets have none, and then the
//      warp only writes -1 for its C slots.  Otherwise each center with a
//      hit counts
//      its bits and asks its Pick for the segment's key (HashPick: the
//      hash of its hit columns alone, packed with the place into a key
//      whose warp-wide maximum, two `redux.sync`, is the pick; FirstPick:
//      one `redux.sync` minimum of the lanes' first hits).  A bucket of up
//      to 1,024 columns (every path shape) is one segment, and its pick is
//      written at once.  A wider bucket (kWide) is scanned segment by
//      segment, lane c keeping center c's best key, and one wider than a
//      block may stage takes a block of its own, which stages it in
//      windows of whole segments and carries the keys from one window to
//      the next.  (Carrying the key on every shape cost K5 a fifth and K11
//      an eighth of their device time, spilling registers.)  Each (center,
//      bucket) slot has one owner block, which writes its pick or -1 (lane
//      c for center c); the block's counts go out as one partial per
//      (center, range).  Buckets past N are never scanned.
//   2. bucket_fill_kernel, a warp per center: the partial counts summed
//      (exact, then capped), the first pick in bucket order found by a
//      ballot, and every empty or never-scanned slot filled with it (0 when
//      there is none).
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
// columns a lane's 32 hit bits cover (a segment of a bucket), and the
// window a block stages at a time where one bucket exceeds kMaxStageCols
constexpr int kSegCols = 32 * 32;
constexpr int kWinCols = kMaxStageCols / kSegCols * kSegCols;

// Uniform parameters of a test (the radius, or the box).
struct Params {
  float v[4];
};

// The TPU kernels' counter hash, top 23 bits: keyed by the center's row in
// its own cloud and the column (group_pallas.py:57-66, crop_pallas.py:70-80).
// `row` is the part that depends on the center alone.
struct Hash23 {
  static __device__ __forceinline__ uint32_t row(int m, uint32_t seed) {
    return (uint32_t)m * 0x9E3779B9u + seed;
  }
  static __device__ __forceinline__ uint32_t score(uint32_t row, int j) {
    uint32_t h = row + (uint32_t)j * 2654435761u;
    h ^= h >> 16;
    h *= 0x45D9F3Bu;
    h ^= h >> 16;
    return h >> 9;
  }
};

// A Pick keeps one column of a bucket from its hits, for a whole warp at
// once, one segment of the bucket at a time: bit s of a lane's `hits`
// marks the column `seg` + 32*s + lane of the bucket whose first column is
// `col`, and `warp_key` (called only where some lane has a hit) returns
// the segment's best as a Key, equal on every lane; `better` keeps the
// better of two keys (so a bucket's best is that of its segments' bests),
// `rel` gives a key's place in the bucket; `row` is what keys a center's
// scores (computed only where its warp has a hit).

// The score pick: the largest score, ties to the first column of the
// bucket.  A lane packs each hit into a 64-bit key, (score + 1) over the
// complement of its place `rel` in the bucket, so that the max of the keys
// is the pick and 0 means no hit; the warp reduces the high word, then the
// low word of the lanes that hold the high word's maximum.  A Score gives
// a u32 below 2^32 - 1 that orders as the scores do.
template <class Score>
struct ScorePick {
  using Key = uint64_t;
  static constexpr Key kNone = 0;
  static __device__ __forceinline__ uint32_t row(int m, uint32_t seed) {
    return Score::row(m, seed);
  }
  static __device__ __forceinline__ Key key(uint32_t score, int rel) {
    return ((uint64_t)(score + 1u) << 32) | (uint32_t)(0xFFFFFFFFu - rel);
  }
  static __device__ __forceinline__ Key warp_key(uint32_t hits, int lane,
                                                 uint32_t row, int col,
                                                 int seg) {
    Key best = 0;
    for (uint32_t h = hits; h; h &= h - 1) {
      const int rel = seg + (__ffs(h) - 1) * 32 + lane;
      const Key k = key(Score::score(row, col + rel), rel);
      best = k > best ? k : best;
    }
    const uint32_t hi = (uint32_t)(best >> 32);
    const uint32_t top = __reduce_max_sync(0xffffffffu, hi);
    const uint32_t lo =
        __reduce_max_sync(0xffffffffu, hi == top ? (uint32_t)best : 0u);
    return ((Key)top << 32) | lo;
  }
  static __device__ __forceinline__ Key better(Key a, Key b) {
    return a > b ? a : b;
  }
  static __device__ __forceinline__ int rel(Key k) {
    return (int)(0xFFFFFFFFu - (uint32_t)k);
  }
};

// K11's and K5's pick: the TPU kernels' hash
using HashPick = ScorePick<Hash23>;

// The first pick: the bucket's first passing column, with no score.  A
// lane's first hit is its lowest set bit; the warp takes the least place.
struct FirstPick {
  using Key = uint32_t;
  static constexpr Key kNone = 0xFFFFFFFFu;
  static __device__ __forceinline__ uint32_t row(int, uint32_t) {
    return 0;
  }
  static __device__ __forceinline__ Key warp_key(uint32_t hits, int lane,
                                                 uint32_t, int, int seg) {
    const uint32_t rel =
        hits ? (uint32_t)(seg + (__ffs(hits) - 1) * 32 + lane) : kNone;
    return __reduce_min_sync(0xffffffffu, rel);
  }
  static __device__ __forceinline__ Key better(Key a, Key b) {
    return a < b ? a : b;
  }
  static __device__ __forceinline__ int rel(Key k) { return (int)k; }
};

// The radius test of K11 (d2 <= r2) and K2 (kStrict: d2 < r2), r2 in p.v[0].
// Differences and squares are rounded one by one in the JAX order,
// ((dx*dx + dy*dy) + dz*dz); K11's reference takes d = center - point and
// K2's d = point - center, which square alike.  8 centers per warp (3
// floats each in registers; for K11, 8 ran faster than 4).
template <bool kStrict>
struct BallTest {
  static constexpr int kPerWarp = 8;
  // 32-column steps a lane unrolls; blocks an SM must hold (<= 80 registers)
  static constexpr int kUnroll = 2, kMinBlocks = 3;
  float cx, cy, cz;
  __device__ __forceinline__ void load(const float*, const float* centers,
                                       size_t row) {
    cx = centers[row * 3];
    cy = centers[row * 3 + 1];
    cz = centers[row * 3 + 2];
  }
  __device__ __forceinline__ bool operator()(float x, float y, float z,
                                             const Params& p) const {
    const float dx = __fsub_rn(cx, x), dy = __fsub_rn(cy, y),
                dz = __fsub_rn(cz, z);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    return kStrict ? d2 < p.v[0] : d2 <= p.v[0];
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

// columns [s0, s1) of a range of `cols` columns from col0 -> s[3][stride]
// from column s0, NaN past the range
__device__ __forceinline__ void stage_range(const float* __restrict__ xyz,
                                            int col0, int cols, int s0,
                                            int s1, int stride, float* s) {
  stage(xyz, col0 + s0, max(0, min(cols - s0, s1 - s0)), s1 - s0, stride, s);
}

// One warp's scan of one segment of a bucket (`steps` 32-column steps from
// `pts`, this lane's first column, in the SoA rows `win` apart): bit s of
// hits[c] marks a pass of center c at column 32*s + lane.  Where any
// center hit, each center with a hit adds its count and hands `take` its
// Pick's key for the segment (center m0 + c; the bucket's first column
// `col`).
template <class Test, class Pick, class Take>
__device__ __forceinline__ void scan_segment(
    const Test (&test)[Test::kPerWarp], int (&cnt)[Test::kPerWarp],
    const float* pts, int win, int steps, const Params& p, int lane,
    int m0, uint32_t seed, int col, int seg, Take take) {
  constexpr int C = Test::kPerWarp;
  uint32_t hits[C];
#pragma unroll
  for (int c = 0; c < C; ++c) hits[c] = 0;
  constexpr int kUnroll = Test::kUnroll;
#pragma unroll kUnroll
  for (int s = 0; s < steps; ++s) {
    const float x = pts[32 * s], y = pts[win + 32 * s],
                z = pts[2 * win + 32 * s];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (test[c](x, y, z, p)) hits[c] |= 1u << s;
  }
  uint32_t any = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) any |= hits[c];
  if (!__any_sync(0xffffffffu, any)) return;  // no center of the warp hit
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (!__any_sync(0xffffffffu, hits[c])) continue;
    cnt[c] += __popc(hits[c]);
    take(c, Pick::warp_key(hits[c], lane,
                           Pick::row(m0 + c, seed), col, seg));
  }
}

// kWide: buckets of more than kSegCols columns, scanned in segments, the
// block's one bucket staged in windows where the range exceeds
// kMaxStageCols; otherwise a bucket is one segment and the range one
// window, and a pick needs no key carried.
template <class Test, class Pick, bool kWide>
__global__ void __launch_bounds__(kThreads, Test::kMinBlocks)
bucket_scan_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ frames,
                   const float* __restrict__ centers, uint32_t seed,
                   int32_t* __restrict__ idx, int32_t* __restrict__ partial,
                   int n, int m_total, int k_total, int bucket, int tile,
                   int range, int nranges, Params p) {
  constexpr int C = Test::kPerWarp;
  using Key = typename Pick::Key;
  extern __shared__ float s_pts[];  // [3][win]
  __shared__ int s_cnt[kMaxTile];

  const int b = blockIdx.y;
  const int t_id = blockIdx.x / nranges, r_id = blockIdx.x % nranges;
  const int stride = range * bucket;
  // the columns staged at a time: the whole range, or windows of whole
  // segments of its one bucket
  const int win = !kWide || stride <= kMaxStageCols ? stride : kWinCols;
  const int col0 = r_id * range * bucket;
  const int cols = min(range * bucket, n - col0);
  const int nbk = (cols + bucket - 1) / bucket;
  const int per_group = kWarps / (tile / C);  // warps sharing C centers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = warp % per_group;
  const int m0 = t_id * tile + (warp / per_group) * C;
  const float* cloud = xyz + (size_t)b * n * 3;

  if (threadIdx.x < tile) s_cnt[threadIdx.x] = 0;
  Test test[C];
  int cnt[C];
  if (m0 < m_total) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // a center past the end is scanned as a copy of the last, unwritten
      test[c].load(frames, centers,
                   (size_t)b * m_total + min(m0 + c, m_total - 1));
      cnt[c] = 0;
    }
  }
  // lane c < C writes center c's slot of each bucket
  int32_t* out = idx + ((size_t)b * m_total + m0 + lane) * k_total +
                 col0 / bucket;
  const bool writes = lane < C && m0 + lane < m_total;
  if (!kWide) {
    stage_range(cloud, col0, cols, 0, nbk * bucket, stride, s_pts);
    __syncthreads();
    if (m0 < m_total) {
      for (int kk = sub; kk < nbk; kk += per_group) {
        const int col = col0 + kk * bucket;  // the bucket's first column
        int pick = -1;
        scan_segment<Test, Pick>(
            test, cnt, s_pts + kk * bucket + lane, stride, bucket / 32, p,
            lane, m0, seed, col, 0, [&](int c, Key k) {
              if (lane == c) pick = col + Pick::rel(k);
            });
        if (writes) out[kk] = pick;
      }
    }
  } else {
    // the columns scanned: the last bucket's up to its last column's step
    const int last = (nbk - 1) * bucket;
    const int end = last + (cols - last + 31) / 32 * 32;
    Key mine = Pick::kNone;  // lane c: center c's best over the segments
    for (int w0 = 0; w0 < end; w0 += win) {
      if (w0) __syncthreads();  // the last window's readers are done
      stage_range(cloud, col0, cols, w0, min(w0 + win, end), win, s_pts);
      __syncthreads();
      if (m0 >= m_total) continue;
      for (int kk = sub; kk < nbk; kk += per_group) {
        const int b0 = kk * bucket, b1 = min(b0 + bucket, end);
        const int col = col0 + kk * bucket;  // the bucket's first column
        const int lo = max(b0, w0), hi = min(b1, w0 + win);
        if (lo >= hi) continue;  // not in this window
        if (lo == b0) mine = Pick::kNone;
        for (int seg = lo; seg < hi; seg += kSegCols)
          scan_segment<Test, Pick>(
              test, cnt, s_pts + (seg - w0) + lane, win,
              min(32, (hi - seg) / 32), p, lane, m0, seed, col, seg - b0,
              [&](int c, Key k) {
                if (lane == c) mine = Pick::better(mine, k);
              });
        if (hi == b1 && writes)  // the bucket's last segment
          out[kk] = mine == Pick::kNone ? -1 : col + Pick::rel(mine);
      }
    }
  }
  if (m0 < m_total) {
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
                   int nranges, int cap) {
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
  if (lane == 0) count[r] = min(c, cap);
}

// Both launches on `stream`; counts capped at `cap`; cudaErrorInvalidValue
// for a grid the kernel does not take (ops/bucket_scan.scan_grid gives only
// ones it takes; `bucket` must be a multiple of 32).
template <class Test, class Pick>
int launch(const float* xyz, const float* frames, const float* centers,
           uint32_t seed, int32_t* idx, int32_t* count, int32_t* partial,
           int batch, int n, int m_total, int k_total, int bucket, int tile,
           int range, int cap, Params p, cudaStream_t stream) {
  constexpr int C = Test::kPerWarp;
  if (batch < 1 || n < 1 || m_total < 1 || bucket < 32 || bucket % 32 ||
      (long long)k_total * bucket < n || tile < C || tile > kMaxTile ||
      tile % C || kWarps % (tile / C) || range < 1 ||
      (range > 1 && (long long)range * bucket > kMaxStageCols))
    return (int)cudaErrorInvalidValue;
  const int nb = (n + bucket - 1) / bucket;
  const int nranges = (nb + range - 1) / range;
  const int tiles = (m_total + tile - 1) / tile;
  const dim3 grid(tiles * nranges, batch);
  const int stride = range * bucket;
  const size_t smem =
      3 * (size_t)(stride <= kMaxStageCols ? stride : kWinCols) * sizeof(float);
  if (bucket <= kSegCols)
    bucket_scan_kernel<Test, Pick, false><<<grid, kThreads, smem, stream>>>(
        xyz, frames, centers, seed, idx, partial, n, m_total, k_total, bucket,
        tile, range, nranges, p);
  else
    bucket_scan_kernel<Test, Pick, true><<<grid, kThreads, smem, stream>>>(
        xyz, frames, centers, seed, idx, partial, n, m_total, k_total, bucket,
        tile, range, nranges, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = batch * m_total;
  bucket_fill_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      idx, partial, count, rows, k_total, nb, nranges, cap);
  return (int)cudaGetLastError();
}

}  // namespace bucket_scan

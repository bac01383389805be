// K6 / K7 — radius grouping and closing-region crop over a sorted cloud,
// with their span tables and the fill of empty slots.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, group_slab and
//   ball_query_slab (_group_slab_kernel) and crop_slab (_crop_slab_kernel),
//   through both of their grids: _slab_select_call (the full grid, slab.py:425)
//   and _slab_flat_call (the flat grid of live steps, slab.py:476).  The two
//   grids scan the same blocks in the same order, so one kernel that owns
//   each (tile, scan block) is the counterpart of both.  The span table
//   (slab_bounds, computed in XLA around the TPU kernel, slab.py:599, :649)
//   and the fill of empty slots are built here too, so that a call is three
//   launches and no host-to-device copy.
// Bound on the H100: arithmetic.  Each (query, scanned row) pair needs the
//   test, 9 float operations for the radius and 22 for the frame transform
//   and box; only a pair that passes needs its 32-bit hash and a place in
//   the window's argmax, about 10 more.  The inputs are a few hundred KB; the
//   slab cuts the pairs to the rows whose x can pass (3 to 8 of 13 blocks
//   per tile at the inference shapes).
// Design, one call in three launches:
//   1. slab_spans_kernel, a block of 128 threads per (tile, batch element):
//      the x-range of the tile's real queries widened by the bound, its cell
//      ids, two 32-way warp searches over the sorted cell ids (one warp
//      each, four dependent loads at 25,600 points), and (start, stop, off)
//      exactly as ops/slab.slab_bounds computes them; it also zeroes the
//      tile's counts.
//   2. slab_select_kernel<Test>, a block of 8 warps per (tile, scan block,
//      group of 32 queries, batch element) over every one of the nblk scan
//      blocks, since the grid cannot follow [start, stop) without a host
//      sync: a block outside its tile's range exits at once.  A live block
//      stages its 2,048 rows once (24 KB, coalesced loads; the cloud is
//      L2-resident) and each warp takes 4 queries, their test parameters in
//      registers, through every window: a lane tests the window's rows
//      lane, lane + 32, ... and packs a passing row's 23-bit hash score + 1
//      over (255 - its place in the window) into a 32-bit key, so that one
//      redux.sync max per stream gives the pick with ties to the lowest
//      row; a window without a passing row (most of them: 0.3 % of the
//      region grouping's pairs pass) skips the streams.  Stream s > 0
//      reshuffles the scores with an odd multiplier, all streams in one
//      pass over the keys; in `distinct` mode it instead drops the previous
//      winner.  The count is
//      a per-lane sum, one redux.sync add and one integer atomicAdd per
//      (query, block): exact in any order.  Each slot (query, span block,
//      window, stream) has one owner block, which writes its pick or -1, so
//      the picks need no atomics; slots of span blocks outside [start, stop)
//      are never written.
//   3. slab_fill_kernel, a warp per query: the first pick in slot order
//      among the slots of scanned span blocks (one redux.sync min), then
//      every other slot filled with it (0 when there is none) and sel_any.
//   Distances and frame products use explicit round-to-nearest intrinsics
//   in the JAX order, and the hash is the TPU kernel's in uint32, so the
//   picks are the JAX package's picks.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 128;           // queries per tile (slab_bounds)
constexpr int kScan = 2048;          // rows per scan block
constexpr int kQ = 32;               // queries per select block
constexpr int kGroups = kTile / kQ;  // select blocks per (tile, scan block)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;       // window rows per lane: win <= 256

__constant__ uint32_t kStreamOdd[4] = {1u, 0x3779B1u, 0x85EBCBu, 0x27D4EDu};

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

struct BallTest {
  float cx, cy, cz, r2;
  __device__ void load(const float*, const float* centers, size_t row,
                       const float* p) {
    cx = centers[row * 3];
    cy = centers[row * 3 + 1];
    cz = centers[row * 3 + 2];
    r2 = p[0];
  }
  __device__ __forceinline__ bool operator()(float x, float y, float z) const {
    const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
                dz = __fsub_rn(z, cz);
    return sum3(__fmul_rn(dx, dx), __fmul_rn(dy, dy), __fmul_rn(dz, dz)) <= r2;
  }
};

struct BoxTest {
  float f[9];  // row-major F[k][j]; columns are the gripper axes
  float cx, cy, cz, xlo, xhi, yabs, zabs;
  __device__ void load(const float* frames, const float* centers, size_t row,
                       const float* p) {
    for (int e = 0; e < 9; ++e) f[e] = frames[row * 9 + e];
    cx = centers[row * 3];
    cy = centers[row * 3 + 1];
    cz = centers[row * 3 + 2];
    xlo = p[0];
    xhi = p[1];
    yabs = p[2];
    zabs = p[3];
  }
  __device__ __forceinline__ bool operator()(float x, float y, float z) const {
    const float r0 = __fsub_rn(x, cx), r1 = __fsub_rn(y, cy),
                r2 = __fsub_rn(z, cz);
    const float l0 = sum3(__fmul_rn(f[0], r0), __fmul_rn(f[3], r1),
                          __fmul_rn(f[6], r2));
    const float l1 = sum3(__fmul_rn(f[1], r0), __fmul_rn(f[4], r1),
                          __fmul_rn(f[7], r2));
    const float l2 = sum3(__fmul_rn(f[2], r0), __fmul_rn(f[5], r1),
                          __fmul_rn(f[8], r2));
    return l0 > xlo && l0 < xhi && fabsf(l1) < yabs && fabsf(l2) < zabs;
  }
};

struct Params {
  float p[4];
};

// Cell id of x as ops/slab._cell_id: floor(x / cell) clamped to +-1e6.
__device__ __forceinline__ int cell_id(float x, float cell) {
  return (int)fminf(fmaxf(floorf(__fdiv_rn(x, cell)), -1e6f), 1e6f);
}

// The first i in [0, n) with row[i] > key (`upper`) or row[i] >= key, n if
// none, in one warp (row nondecreasing): each pass probes 32 evenly spaced
// rows and keeps the stretch between the last probe below the answer and
// the first at or above it, so 25,600 rows take four passes.
__device__ int warp_search(const int32_t* row, int n, int key, bool upper) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && (upper ? row[p] <= key : row[p] < key);
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(lo + c * step, hi);
      lo = lo + (c - 1) * step + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kTile)
slab_spans_kernel(const int32_t* __restrict__ cell_row,
                  const float* __restrict__ centers, int n, int m_total,
                  int nblk, int span_b, float bound, float cell,
                  int32_t* __restrict__ ss, int32_t* __restrict__ off_out,
                  int32_t* __restrict__ count) {
  __shared__ float s_lo[kTile / 32], s_hi[kTile / 32];
  __shared__ int s_row[2];
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = tile * kTile + threadIdx.x;
  // pad queries hold 1e10, as ops/slab._pad_queries makes them
  const float qx = m < m_total ? centers[((size_t)b * m_total + m) * 3] : 1e10f;
  if (m < m_total) count[(size_t)b * m_total + m] = 0;
  const bool real = qx < 1e9f;
  float lo = real ? qx : INFINITY, hi = real ? qx : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < kTile / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  const bool any_real = lo != INFINITY;  // else the tile is pad queries only
  lo = any_real ? __fsub_rn(lo, bound) : 1e9f;
  hi = any_real ? __fadd_rn(hi, bound) : 1e9f;
  const int32_t* row = cell_row + (size_t)b * n;
  if (warp < 2) {
    const int r = warp == 0 ? warp_search(row, n, cell_id(lo, cell), false)
                            : warp_search(row, n, cell_id(hi, cell), true);
    if (lane == 0) s_row[warp] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int srow = s_row[0], erow = s_row[1];
    const int start = min(srow / kScan, nblk - 1);
    const int stop = min(max((erow + kScan - 1) / kScan, start + 1), nblk);
    const int mid = (srow + erow) / (2 * kScan);
    const int off = stop - start <= span_b
                        ? min(start, nblk - span_b)
                        : min(max(mid - span_b / 2, 0), nblk - span_b);
    int32_t* s3 = ss + ((size_t)b * tiles + tile) * 3;
    s3[0] = start;
    s3[1] = stop;
    s3[2] = off;
    off_out[(size_t)b * tiles + tile] = off;
  }
}

template <class Test>
__global__ void __launch_bounds__(kThreads)
slab_select_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ frames,
                   const float* __restrict__ centers,
                   const int32_t* __restrict__ ss, uint32_t seed,
                   int32_t* __restrict__ idx, int32_t* __restrict__ count,
                   int n, int m_total, int k_total, int nblk, int span_b,
                   int win, int spw, int distinct, Params params) {
  __shared__ float rows[kScan * 3];  // x, y, z of the block's rows

  const int b = blockIdx.y;
  const int qg = blockIdx.x % kGroups;
  const int kb = (blockIdx.x / kGroups) % nblk;
  const int tile = blockIdx.x / (kGroups * nblk);
  const int tiles = gridDim.x / (kGroups * nblk);
  const int m0 = tile * kTile + qg * kQ;
  if (m0 >= m_total) return;
  const int32_t* s3 = ss + ((size_t)b * tiles + tile) * 3;
  const int start = s3[0], stop = s3[1], off = s3[2];
  if (kb < start || kb >= stop) return;

  const int col0 = kb * kScan;
  const int nrows = min(kScan, n - col0);
  const float* src = xyz + ((size_t)b * n + col0) * 3;
  int t0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = nrows * 3 / 4;
    for (int t = threadIdx.x; t < n4; t += blockDim.x)
      reinterpret_cast<float4*>(rows)[t] =
          __ldg(reinterpret_cast<const float4*>(src) + t);
    t0 = n4 * 4;
  }
  for (int t = t0 + threadIdx.x; t < nrows * 3; t += blockDim.x)
    rows[t] = __ldg(src + t);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwin = kScan / win, per_lane = win / 32, rps = nwin * spw;
  const bool in_span = kb >= off && kb < off + span_b;

  for (int ql = warp; ql < kQ; ql += kWarps) {
    const int m = m0 + ql;
    if (m >= m_total) break;
    const size_t row = (size_t)b * m_total + m;
    Test test;
    test.load(frames, centers, row, params.p);
    const uint32_t hrow = (uint32_t)m * 0x9E3779B9u + seed;
    int32_t* out = idx + row * k_total + (size_t)(kb - off) * rps;
    int cnt = 0;

    for (int w = 0; w < nwin; ++w) {
      const int base = w * win;
      uint32_t key[kMaxPerLane];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        key[j] = 0;
        const int rel = j * 32 + lane;  // the row's place in the window
        const int t = base + rel;
        if (j < per_lane && t < nrows &&
            test(rows[3 * t], rows[3 * t + 1], rows[3 * t + 2])) {
          ++cnt;
          uint32_t h = hrow + (uint32_t)(col0 + t) * 2654435761u;
          h ^= h >> 16;
          h *= 0x45D9F3Bu;
          h ^= h >> 16;
          key[j] = (((h >> 9) + 1u) << 8) | (uint32_t)(255 - rel);
          any = true;
        }
      }
      // lane s writes stream s's slot: its pick, or -1 for none
      int pick = -1;
      if (!__any_sync(0xffffffffu, any)) {
        // most windows hold no passing row: no stream to reduce
      } else if (distinct) {  // without replacement: drop each winner
        for (int s = 0; s < spw; ++s) {
          uint32_t best = 0;
#pragma unroll
          for (int j = 0; j < kMaxPerLane; ++j)
            best = key[j] > best ? key[j] : best;
          best = __reduce_max_sync(0xffffffffu, best);
          if (!best) break;
          const int rel = 255 - (int)(best & 255u);
          if (lane == s) pick = col0 + base + rel;
#pragma unroll
          for (int j = 0; j < kMaxPerLane; ++j)
            if (j == (rel >> 5) && lane == (rel & 31)) key[j] = 0;
        }
      } else {  // stream s > 0: the scores reshuffled, the same row bits
        uint32_t best[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          const uint32_t k = key[j];
          if (k) {
            const uint32_t score = (k >> 8) - 1u, low = k & 255u;
            best[0] = k > best[0] ? k : best[0];
#pragma unroll
            for (int s = 1; s < 4; ++s) {
              const uint32_t r =
                  ((((score * kStreamOdd[s]) & 0x7FFFFFu) + 1u) << 8) | low;
              best[s] = r > best[s] ? r : best[s];
            }
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < spw) {
            const uint32_t b = __reduce_max_sync(0xffffffffu, best[s]);
            if (lane == s && b) pick = col0 + base + 255 - (int)(b & 255u);
          }
        }
      }
      if (in_span && lane < spw) out[w * spw + lane] = pick;
    }
    cnt = (int)__reduce_add_sync(0xffffffffu, (unsigned)cnt);
    if (lane == 0 && cnt) atomicAdd(count + row, cnt);
  }
}

__global__ void __launch_bounds__(kThreads)
slab_fill_kernel(const int32_t* __restrict__ ss, int32_t* __restrict__ idx,
                 uint8_t* __restrict__ sel_any, int rows_total, int m_total,
                 int k_total, int tiles, int span_b) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows_total) return;
  const int b = r / m_total, m = r % m_total;
  const int32_t* s3 = ss + ((size_t)b * tiles + m / kTile) * 3;
  const int start = s3[0], stop = s3[1], off = s3[2];
  const int rps = k_total / span_b;
  // the slots of the span blocks that were scanned; the others were never
  // written and count as empty
  const int j_lo = max(start - off, 0) * rps;
  const int j_hi = min(stop - off, span_b) * rps;
  int32_t* row = idx + (size_t)r * k_total;
  int firstj = INT_MAX;
  for (int j = j_lo + lane; j < j_hi; j += 32)
    if (row[j] >= 0) {
      firstj = j;
      break;
    }
  firstj = __reduce_min_sync(0xffffffffu, firstj);
  const int first = firstj < INT_MAX ? row[firstj] : -1;
  const int fill = max(first, 0);
  for (int j = lane; j < k_total; j += 32)
    if (j < j_lo || j >= j_hi || row[j] < 0) row[j] = fill;
  if (lane == 0) sel_any[r] = first >= 0;
}

template <class Test>
int launch(const float* xyz, const int32_t* cell_row, const float* frames,
           const float* centers, uint32_t seed, int32_t* idx, int32_t* count,
           uint8_t* sel_any, int32_t* ss, int32_t* off, int batch, int n,
           int m_total, int k_total, int span_b, int win, int spw,
           int distinct, float bound, float cell, Params params,
           cudaStream_t stream) {
  const int nblk = (n + kScan - 1) / kScan;
  if (win % 32 || win > 32 * kMaxPerLane || kScan % win || spw < 1 ||
      spw > 4 || n < 1 || m_total < 1 || batch < 1 || span_b < 1 ||
      span_b > nblk || k_total != span_b * (kScan / win) * spw)
    return (int)cudaErrorInvalidValue;
  const int tiles = (m_total + kTile - 1) / kTile;
  slab_spans_kernel<<<dim3(tiles, batch), kTile, 0, stream>>>(
      cell_row, centers, n, m_total, nblk, span_b, bound, cell, ss, off,
      count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slab_select_kernel<Test>
      <<<dim3(tiles * nblk * kGroups, batch), kThreads, 0, stream>>>(
          xyz, frames, centers, ss, seed, idx, count, n, m_total, k_total,
          nblk, span_b, win, spw, distinct, params);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_total = batch * m_total;
  slab_fill_kernel<<<(rows_total + kWarps - 1) / kWarps, kThreads, 0,
                     stream>>>(ss, idx, sel_any, rows_total, m_total, k_total,
                               tiles, span_b);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz [B, N, 3] sorted cloud, cell_row [B, N] int32 its nondecreasing cell
// ids, centers [B, M, 3] f32, u32 seed, the radius test d2 <= r2, the
// largest |x - cx| that passes (`bound`) and the cell size -> idx [B, M, K]
// int32 picks with empty slots filled, count [B, M] exact in-radius
// population, sel_any [B, M] bool (uint8), off [B, T] int32 the selection
// span origins and ss [B, T, 3] int32 the whole span table (start, stop,
// off) per tile of 128 queries.
extern "C" int regnet_group_slab(const float* xyz, const int32_t* cell_row,
                                 const float* centers, uint32_t seed,
                                 int32_t* idx, int32_t* count,
                                 uint8_t* sel_any, int32_t* off, int32_t* ss,
                                 int batch, int n, int m_total, int k_total,
                                 int span_b, int win, int spw, int distinct,
                                 float r2, float bound, float cell,
                                 cudaStream_t stream) {
  Params params = {{r2, 0.f, 0.f, 0.f}};
  return launch<BallTest>(xyz, cell_row, nullptr, centers, seed, idx, count,
                          sel_any, ss, off, batch, n, m_total, k_total,
                          span_b, win, spw, distinct, bound, cell, params,
                          stream);
}

// As above with frames [B, M, 9] (row-major 3x3, columns = gripper axes) and
// the box xlo < x < xhi, |y| < yabs, |z| < zabs in the gripper frame; one
// pick per 256-row window.
extern "C" int regnet_crop_slab(const float* xyz, const int32_t* cell_row,
                                const float* frames, const float* centers,
                                uint32_t seed, int32_t* idx, int32_t* count,
                                uint8_t* sel_any, int32_t* off, int32_t* ss,
                                int batch, int n, int m_total, int k_total,
                                int span_b, float xlo, float xhi, float yabs,
                                float zabs, float bound, float cell,
                                cudaStream_t stream) {
  Params params = {{xlo, xhi, yabs, zabs}};
  return launch<BoxTest>(xyz, cell_row, frames, centers, seed, idx, count,
                         sel_any, ss, off, batch, n, m_total, k_total, span_b,
                         256, 1, 0, bound, cell, params, stream);
}

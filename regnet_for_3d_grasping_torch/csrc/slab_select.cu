// K6 / K7 — radius grouping and closing-region crop over a sorted cloud.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, group_slab and
//   ball_query_slab (_group_slab_kernel) and crop_slab (_crop_slab_kernel),
//   through both of their grids: _slab_select_call (the full grid, slab.py:425)
//   and _slab_flat_call (the flat grid of live steps, slab.py:476).  The two
//   grids scan the same blocks in the same order; a thread block that walks
//   [start, stop) itself is the counterpart of both.
// Bound on the H100: arithmetic.  Each (query, scanned row) pair needs the
//   test, 9 float operations for the radius and 22 for the frame transform
//   and box; only a pair that passes needs its 32-bit hash and a place in
//   the window's argmax, about 10 more.  The inputs are a few hundred KB; the
//   slab cuts the pairs to the rows whose x can pass (3 to 8 of 13 blocks
//   per tile at the inference shapes).
// Design: the tile of 128 queries for which the wrapper computed
//   (start, stop, off) is split over 4 thread blocks of 8 warps, so that a
//   few dozen tiles still fill the card.  A thread block stages each
//   2,048-row block of its span in shared memory (24 KB) and every warp takes
//   whole (query, window) pairs: a lane tests the window's rows lane,
//   lane + 32, ..., keeps their 23-bit hash scores (-1 when the row fails) in
//   registers, ballots give the exact count, and a butterfly reduction over
//   (score, lowest row) gives each stream's pick.  Stream s > 0 reshuffles
//   the scores with an odd multiplier; in `distinct` mode it instead drops
//   the previous winner (sampling without replacement).  A warp owns its
//   queries across all blocks and windows, so the first pick in
//   (block, window, stream) order needs no atomics.  Picks are written only
//   inside the selection span [off, off + span); slots of span blocks that
//   were never scanned stay -1.  Distances and frame products use explicit
//   round-to-nearest intrinsics in the JAX order, and the hash is the TPU
//   kernel's in uint32, so the picks are the JAX package's picks.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 128;           // queries per tile (slab_bounds)
constexpr int kScan = 2048;          // rows per scan block
constexpr int kSub = 4;              // thread blocks per tile
constexpr int kQ = kTile / kSub;     // queries per thread block
constexpr int kWarps = 8;
constexpr int kMaxPerLane = 8;       // window rows per lane: win <= 256

__device__ const uint32_t kStreamOdd[4] = {1u, 0x3779B1u, 0x85EBCBu,
                                           0x27D4EDu};

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

template <class Test>
__global__ void __launch_bounds__(kWarps * 32)
slab_select_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ frames,
                   const float* __restrict__ centers,
                   const int32_t* __restrict__ ss, uint32_t seed,
                   int32_t* __restrict__ idx, int32_t* __restrict__ count,
                   int32_t* __restrict__ first_out, int n, int m_total,
                   int k_total, int span_b, int win, int spw, int distinct,
                   Params params) {
  __shared__ float sx[kScan], sy[kScan], sz[kScan];
  __shared__ int s_cnt[kQ], s_first[kQ];

  const int b = blockIdx.y;
  const int tile = blockIdx.x / kSub;
  const int m0 = tile * kTile + (blockIdx.x % kSub) * kQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = gridDim.x / kSub;
  const int32_t* s3 = ss + ((size_t)b * tiles + tile) * 3;
  const int start = s3[0], stop = s3[1], off = s3[2];
  const int nwin = kScan / win, per_lane = win / 32;
  const int rps = nwin * spw;  // slots per scan block
  xyz += (size_t)b * n * 3;

  for (int t = threadIdx.x; t < kQ * k_total; t += blockDim.x) {
    const int m = m0 + t / k_total;
    if (m < m_total)
      idx[((size_t)b * m_total + m) * k_total + t % k_total] = -1;
  }
  if (threadIdx.x < kQ) {
    s_cnt[threadIdx.x] = 0;
    s_first[threadIdx.x] = -1;
  }

  for (int kb = start; kb < stop; ++kb) {
    __syncthreads();
    const int col0 = kb * kScan;
    for (int t = threadIdx.x; t < kScan; t += blockDim.x) {
      const int j = col0 + t;
      if (j < n) {
        sx[t] = xyz[3 * j];
        sy[t] = xyz[3 * j + 1];
        sz[t] = xyz[3 * j + 2];
      }
    }
    __syncthreads();
    const bool in_span = kb >= off && kb < off + span_b;

    for (int ql = warp; ql < kQ; ql += kWarps) {
      const int m = m0 + ql;
      if (m >= m_total) break;
      const size_t row = (size_t)b * m_total + m;
      Test test;
      test.load(frames, centers, row, params.p);
      const uint32_t hrow = (uint32_t)m * 0x9E3779B9u + seed;
      int cnt = 0, first = s_first[ql];

      for (int w = 0; w < nwin; ++w) {
        const int base = w * win;
        int hv[kMaxPerLane];
#pragma unroll
        for (int j = 0; j < kMaxPerLane; ++j) {
          hv[j] = -1;
          if (j < per_lane) {
            const int t = base + j * 32 + lane;
            const int col = col0 + t;
            const bool pass = col < n && test(sx[t], sy[t], sz[t]);
            cnt += __popc(__ballot_sync(0xffffffffu, pass));
            if (pass) {
              uint32_t h = hrow + (uint32_t)col * 2654435761u;
              h ^= h >> 16;
              h *= 0x45D9F3Bu;
              h ^= h >> 16;
              hv[j] = (int)(h >> 9);
            }
          }
        }
        for (int s = 0; s < spw; ++s) {
          const uint32_t odd = kStreamOdd[s];
          int best = -1, bcol = INT_MAX;
#pragma unroll
          for (int j = 0; j < kMaxPerLane; ++j) {
            int v = hv[j];
            if (!distinct && s > 0 && v >= 0)
              v = (int)(((uint32_t)v * odd) & 0x7FFFFFu);
            if (v > best) {  // rows ascend with j: ties keep the lowest
              best = v;
              bcol = base + j * 32 + lane;
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            const int ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oc = __shfl_xor_sync(0xffffffffu, bcol, o);
            if (ob > best || (ob == best && oc < bcol)) {
              best = ob;
              bcol = oc;
            }
          }
          if (best < 0) continue;  // no row left in this window
          const int wrow = col0 + bcol;
          if (in_span && lane == 0) {
            idx[row * k_total + (kb - off) * rps + w * spw + s] = wrow;
            if (first < 0) first = wrow;
          }
          if (distinct) {  // without replacement: drop the winner
            const int rel = bcol - base;
#pragma unroll
            for (int j = 0; j < kMaxPerLane; ++j)
              if (j == (rel >> 5) && lane == (rel & 31)) hv[j] = -1;
          }
        }
      }
      if (lane == 0) {
        s_cnt[ql] += cnt;
        s_first[ql] = first;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kQ && m0 + threadIdx.x < m_total) {
    const size_t row = (size_t)b * m_total + m0 + threadIdx.x;
    count[row] = s_cnt[threadIdx.x];
    first_out[row] = s_first[threadIdx.x];
  }
}

template <class Test>
int launch(const float* xyz, const float* frames, const float* centers,
           const int32_t* ss, uint32_t seed, int32_t* idx, int32_t* count,
           int32_t* first, int batch, int n, int m_total, int k_total,
           int span_b, int win, int spw, int distinct, Params params,
           cudaStream_t stream) {
  if (win % 32 || win > 32 * kMaxPerLane || kScan % win || spw < 1 || spw > 4)
    return (int)cudaErrorInvalidValue;
  const int tiles = (m_total + kTile - 1) / kTile;
  dim3 grid(tiles * kSub, batch);
  slab_select_kernel<Test><<<grid, kWarps * 32, 0, stream>>>(
      xyz, frames, centers, ss, seed, idx, count, first, n, m_total, k_total,
      span_b, win, spw, distinct, params);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz [B, N, 3] sorted cloud, centers [B, M, 3] f32, ss [B, T, 3] int32
// (start, stop, off) per tile of 128 queries, u32 seed -> idx [B, M, K]
// int32 raw picks (-1 = empty slot), count [B, M] exact in-radius
// population, first [B, M] first in-span pick or -1.
extern "C" int regnet_group_slab(const float* xyz, const float* centers,
                                 const int32_t* ss, uint32_t seed,
                                 int32_t* idx, int32_t* count, int32_t* first,
                                 int batch, int n, int m_total, int k_total,
                                 int span_b, int win, int spw, int distinct,
                                 float r2, cudaStream_t stream) {
  Params params = {{r2, 0.f, 0.f, 0.f}};
  return launch<BallTest>(xyz, nullptr, centers, ss, seed, idx, count, first,
                          batch, n, m_total, k_total, span_b, win, spw,
                          distinct, params, stream);
}

// As above with frames [B, M, 9] (row-major 3x3, columns = gripper axes) and
// the box xlo < x < xhi, |y| < yabs, |z| < zabs in the gripper frame; one
// pick per 256-row window.
extern "C" int regnet_crop_slab(const float* xyz, const float* frames,
                                const float* centers, const int32_t* ss,
                                uint32_t seed, int32_t* idx, int32_t* count,
                                int32_t* first, int batch, int n, int m_total,
                                int k_total, int span_b, float xlo, float xhi,
                                float yabs, float zabs, cudaStream_t stream) {
  Params params = {{xlo, xhi, yabs, zabs}};
  return launch<BoxTest>(xyz, frames, centers, ss, seed, idx, count, first,
                         batch, n, m_total, k_total, span_b, 256, 1, 0, params,
                         stream);
}

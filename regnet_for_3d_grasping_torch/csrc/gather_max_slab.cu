// K9 — max over gathered rows for slab-structured indices (region and
// refine pooling in slab mode), with its argmax form for training.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, gather_max_slab
//   (_gmax_slab_kernel, slab.py:1072).
// Bound on the H100: memory traffic from L2.  Each output value is a max
//   over the covered rows of its query (at most K, 256 at the region pool
//   of 4,000 x 256 x 256) where the function's own inputs are 26 MB of
//   features, which fit the 50 MB L2, and 4 MB of indices; the rows read
//   again by neighbouring queries come from L2, so the floor is the L2 rate
//   over the covered rows, and a thread that waits on one load at a time
//   is bound by the L2's latency instead.
// Design: the TPU kernel fetches, per tile and span block, a 2,048-row
//   window of features and picks rows out of it with one-hot matrix products
//   over a 3-way bf16 split, because the TPU has no fast gather; a slot whose
//   row lies outside its own window gets an all-zero one-hot and so drops
//   out.  Here it is a direct gather that keeps that cover rule, since the
//   rule decides the result for rows with no pick (they pool to -1e38) and
//   for partly filled rows.  One block of 256 threads per (batch, query):
//   first it compacts the query's cover into a dense list of rows in shared
//   memory, in slot order (ballot and prefix count per warp), keeping a row
//   that the slot before repeats once, as padded regions do, since a max
//   over copies is the same max; then the block splits into row groups of
//   C/4 threads, each thread owning four channels read as one 16-byte load,
//   each group taking every fourth row of the list with four row loads in
//   flight, and the groups' maxima are combined in shared memory.  No
//   thread walks an uncovered slot.  The result is bit-exact (a max of
//   copied values).  Training uses the argmax form (slab.py:996-1014),
//   which also writes the winner's source row: the lowest covered slot
//   holding the maximum (a group keeps its first maximal list position, the
//   combination the lowest position among equal maxima, and the list keeps
//   slot order with the first of repeated rows), 0 for a row with no
//   covered slot.  Its backward is the scatter kernel of gather_max.cu.
//   The bf16 form (the TPU kernel's bf16 branch, `terms = (fw,)`,
//   slab.py:969) is the same kernel on 16-bit rows, the same 4 channels a
//   thread (an 8-byte load): values compared as the f32 they widen to and
//   copied bit for bit, and a query with no covered slot pools to
//   bf16(-1e38), the sentinel JAX stores in bf16 (`jnp.full(..., -_BIG,
//   dtype)`, :955).  Its entry point also runs 8 channels a thread
//   (16-byte loads, 8 row groups a block), which the wrapper never asks
//   for: chip_smoke.py times it beside the 4-channel form (PERF.md).  Its
//   argmax form (bf16 training; slab.py:996-1010, which compares in f32
//   and stores the f32 pick back to bf16 losslessly) is the argmax form
//   above on 16-bit rows at 4 channels a thread: the winner's value
//   copied bit for bit, bf16(-1e38) and winner 0 for a query with no
//   covered slot.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // queries per tile (one `off` each)
constexpr int kScan = 2048;   // rows per scan block
constexpr int kUnroll = 4;    // row loads in flight per thread

// Element types: float, and bf16 as its 16 raw bits (uint16_t), compared
// as the f32 it widens to and copied bit for bit; a thread owns the V
// channels of one load (V = 4: 16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ float value(uint16_t x) {
  return __uint_as_float((unsigned)x << 16);
}
// -1e38, the pooled "nothing", as each type stores it: bf16(-1e38) rounds
// to nearest even to 0xfe96 (-9.9692e37), what JAX's bf16 `jnp.full` holds
template <typename E>
__device__ __forceinline__ E nothing();
template <>
__device__ __forceinline__ float nothing<float>() {
  return -1e38f;
}
template <>
__device__ __forceinline__ uint16_t nothing<uint16_t>() {
  return 0xfe96u;
}

template <typename T, int L>
struct alignas(sizeof(T) * L) Vec {
  T v[L];
};

// Slot k's row when it lies in the slot's own window, else -1.
__device__ __forceinline__ int covered_row(const int32_t* idx, int k, int off,
                                           int rps, int spw, int win, int n) {
  const int r = idx[k];
  const int base = (off + k / rps) * kScan + (k % rps) / spw * win;
  return (r >= base && r < base + win && r < n) ? r : -1;
}

// Writes the covered rows of one query's K slots, in slot order, a row
// repeated by the slot before it once, to s_list; returns their count.
__device__ int compact_cover(const int32_t* idx, int off, int rps, int spw,
                             int win, int n, int k_total, int* s_list,
                             int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int k0 = 0; k0 < k_total; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const int r = k < k_total ? covered_row(idx, k, off, rps, spw, win, n) : -1;
    const int prev = (k > 0 && k < k_total)
                         ? covered_row(idx, k - 1, off, rps, spw, win, n)
                         : -1;
    const bool keep = r >= 0 && r != prev;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = total, after = total;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      before += w < warp ? s_warp[w] : 0;
      after += s_warp[w];
    }
    if (keep) s_list[before + __popc(ballot & ((1u << lane) - 1))] = r;
    total = after;
    __syncthreads();
  }
  return total;
}

// Folds value v at list position i into (m, p): plain max (NaN wins and
// stays) or, for the argmax form, the first strict maximum.
template <bool kArgmax, typename E>
__device__ __forceinline__ void take(E& m, int& p, E v, int i) {
  const float x = value(v), y = value(m);
  if (kArgmax) {
    if (x > y) {
      m = v;
      p = i;
    }
  } else if (x > y || x != x) {
    m = v;
  }
}

// Grid (S, B), kThreads threads, V channels a thread; C a multiple of V
// and the arrays aligned to a load of V elements (the launch refuses
// anything else).
template <typename E, bool kArgmax, int V>
__global__ void __launch_bounds__(kThreads)
gather_max_slab_kernel(const E* __restrict__ feature,
                       const int32_t* __restrict__ index,
                       const int32_t* __restrict__ off_blk,
                       E* __restrict__ out, int32_t* __restrict__ winner,
                       int n, int c_total, int s_total, int k_total, int win,
                       int spw) {
  using FV = Vec<E, V>;
  using IV = Vec<int, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  FV* s_max = reinterpret_cast<FV*>(smem);              // [kThreads]
  IV* s_pos = reinterpret_cast<IV*>(s_max + kThreads);  // [kThreads]
  int* s_list = reinterpret_cast<int*>(s_pos + (kArgmax ? kThreads : 0));
  __shared__ int s_warp[kThreads / 32];

  const int b = blockIdx.y, s = blockIdx.x;
  const size_t row = (size_t)b * s_total + s;
  const int tiles = (s_total + kTile - 1) / kTile;
  const int off = off_blk[(size_t)b * tiles + s / kTile];
  const int cnt = compact_cover(index + row * k_total, off,
                                (kScan / win) * spw, spw, win, n, k_total,
                                s_list, s_warp);

  // thread -> (row group g, channel vector j); groups > 1 only when one
  // pass covers every vector, so the loop below then runs once
  const int cols = c_total / V;
  const int cols_t = cols < kThreads ? cols : kThreads;
  const int groups = kThreads / cols_t;
  const int g = threadIdx.x / cols_t;
  const FV* f = reinterpret_cast<const FV*>(feature + (size_t)b * n * c_total);
  for (int j = threadIdx.x % cols_t; j < cols; j += cols_t) {
    FV m;
    IV p;
    for (int e = 0; e < V; ++e) {
      m.v[e] = nothing<E>();
      p.v[e] = INT_MAX;
    }
    if (g < groups) {
      int i = g;
      for (; i + (kUnroll - 1) * groups < cnt; i += kUnroll * groups) {
        FV v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = f[(size_t)s_list[i + u * groups] * cols + j];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e)
            take<kArgmax>(m.v[e], p.v[e], v[u].v[e], i + u * groups);
      }
      for (; i < cnt; i += groups) {
        const FV v = f[(size_t)s_list[i] * cols + j];
#pragma unroll
        for (int e = 0; e < V; ++e) take<kArgmax>(m.v[e], p.v[e], v.v[e], i);
      }
    }
    if (groups > 1) {
      s_max[threadIdx.x] = m;
      if (kArgmax) s_pos[threadIdx.x] = p;
      __syncthreads();
      if (g == 0) {
        for (int h = 1; h < groups; ++h) {
          const FV o = s_max[h * cols_t + j];
          IV q;
          if (kArgmax) q = s_pos[h * cols_t + j];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = value(o.v[e]), y = value(m.v[e]);
            if (kArgmax) {
              if (x > y || (x == y && q.v[e] < p.v[e])) {
                m.v[e] = o.v[e];
                p.v[e] = q.v[e];
              }
            } else if (x > y || x != x) {
              m.v[e] = o.v[e];
            }
          }
        }
      }
    }
    if (g == 0) {
      reinterpret_cast<FV*>(out + row * c_total)[j] = m;
      if (kArgmax) {
        IV w;
#pragma unroll
        for (int e = 0; e < V; ++e)
          w.v[e] = p.v[e] == INT_MAX ? 0 : s_list[p.v[e]];
        reinterpret_cast<IV*>(winner + row * c_total)[j] = w;
      }
    }
  }
}

template <typename E, bool kArgmax, int V = 4>
int launch(const E* feature, const int32_t* index, const int32_t* off_blk,
           E* out, int32_t* winner, int batch, int n, int c_total,
           int s_total, int k_total, int win, int spw, cudaStream_t stream) {
  if (c_total % V != 0 ||
      ((uintptr_t)feature | (uintptr_t)out) % sizeof(Vec<E, V>) != 0 ||
      (uintptr_t)winner % sizeof(Vec<int, V>) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kThreads * (sizeof(Vec<E, V>) + (kArgmax ? V * 4 : 0)) +
      (size_t)k_total * sizeof(int);
  const dim3 grid(s_total, batch);
  auto kernel = gather_max_slab_kernel<E, kArgmax, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(feature, index, off_blk, out,
                                           winner, n, c_total, s_total,
                                           k_total, win, spw);
  return (int)cudaGetLastError();
}

}  // namespace

// feature [B, N, C] f32 (C a multiple of 4, 16-byte aligned, as out and
// winner), index [B, S, K] int32, off_blk [B, ceil(S/128)] int32 ->
// out [B, S, C]: the max over the slots k whose row lies in the
// slot's own window [(off + k / rps) * 2048 + (k % rps) / spw * win, + win),
// -1e38 where no slot is covered.
extern "C" int regnet_gather_max_slab(const float* feature,
                                      const int32_t* index,
                                      const int32_t* off_blk, float* out,
                                      int batch, int n, int c_total,
                                      int s_total, int k_total, int win,
                                      int spw, cudaStream_t stream) {
  return launch<float, false>(feature, index, off_blk, out, nullptr, batch,
                              n, c_total, s_total, k_total, win, spw, stream);
}

// The same on bf16 features (their raw 16 bits): out [B, S, C] bf16, bit
// for bit the max over the covered slots, bf16(-1e38) where no slot is
// covered; `vec` channels a thread, 4 (8-byte aligned) or 8 (C a multiple
// of 8, 16-byte aligned).
extern "C" int regnet_gather_max_slab_bf16(const uint16_t* feature,
                                           const int32_t* index,
                                           const int32_t* off_blk,
                                           uint16_t* out, int batch, int n,
                                           int c_total, int s_total,
                                           int k_total, int win, int spw,
                                           int vec, cudaStream_t stream) {
  if (vec == 8)
    return launch<uint16_t, false, 8>(feature, index, off_blk, out, nullptr,
                                      batch, n, c_total, s_total, k_total,
                                      win, spw, stream);
  if (vec != 4) return (int)cudaErrorInvalidValue;
  return launch<uint16_t, false, 4>(feature, index, off_blk, out, nullptr,
                                    batch, n, c_total, s_total, k_total, win,
                                    spw, stream);
}

// The same, and winner [B, S, C] int32: the row of the lowest covered slot
// holding the maximum, 0 where no slot is covered.
extern "C" int regnet_gather_max_slab_argmax(
    const float* feature, const int32_t* index, const int32_t* off_blk,
    float* out, int32_t* winner, int batch, int n, int c_total, int s_total,
    int k_total, int win, int spw, cudaStream_t stream) {
  return launch<float, true>(feature, index, off_blk, out, winner, batch, n,
                             c_total, s_total, k_total, win, spw, stream);
}

// The argmax form on bf16 features (their raw 16 bits), 4 channels a
// thread (8-byte aligned): out bf16, the winner's value bit for bit,
// bf16(-1e38) and winner 0 where no slot is covered.
extern "C" int regnet_gather_max_slab_argmax_bf16(
    const uint16_t* feature, const int32_t* index, const int32_t* off_blk,
    uint16_t* out, int32_t* winner, int batch, int n, int c_total,
    int s_total, int k_total, int win, int spw, cudaStream_t stream) {
  return launch<uint16_t, true>(feature, index, off_blk, out, winner, batch,
                                n, c_total, s_total, k_total, win, spw,
                                stream);
}

// K8 — three nearest neighbours over each query tile's key span (FP3 in
// slab mode), with its span table and exactness certificate; and K8 flat,
// the same search over the unclamped spans where they are few enough.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/slab.py, three_nn_slab
//   (_three_nn_slab_kernel on its bounded grid, slab.py:853; the span
//   table, slab.py:805-835, and the certificate, slab.py:904-923), and
//   three_nn_slab(flat=True) (the flat grid, slab.py:885, `_flat_steps`
//   :211-239, chosen by `lax.cond` where the unclamped spans sum to at
//   most G = B*T*5/2 (tile, block) steps, :892-901).
// Bound on the H100: arithmetic.  A query meets only the keys of its tile's
//   span, about 2.3 of 5 blocks of 1,024 at the FP3 shape (25,600 queries,
//   5,120 keys): some 60 M distances of 9 operations plus a compare each,
//   over inputs of a few hundred KB.
// Design: three launches and no host sync.
//   1. `slab_nn_span_kernel`, one warp per (batch, tile of 256 queries):
//      the tile's x-range over its real queries (x < 1e9, as JAX's `realq`)
//      widened by `bound`, both ends found over the x-sorted keys by a
//      32-way search of the warp (searchsorted left and right), the
//      JAX clamp to `cap` blocks recentred, and the x of the nearest
//      unscanned key on either side (+-1e38 past the ends).  It also
//      resets the call's flags.  The flat form also writes the unclamped
//      spans and their bounds, and adds each tile's unclamped span to the
//      call's total of live (tile, block) pairs (an integer atomic).
//   2. `slab_nn_split_kernel`: K3's scan (`three_nn::scan_keys`: keys
//      staged as float4, 4-key batched insertion tests, strict `<` in
//      ascending index), a block of 128 threads x Q queries of one tile
//      against one part of one block of the tile's span; blocks past the
//      span's stop return at once.  The grid (Q, parts a block) comes
//      from `ops/slab.three_nn_slab_grid`, which aims at 12 blocks a SM
//      (a kernel of one block a tile ran 100 blocks on 132 SMs at FP3; a
//      walk outward from the queries, which inserts less on x-sorted keys,
//      ran slower: see PERF.md).  The flat form decides on the card: every
//      block reads the total, and scans the unclamped spans where it is at
//      most G, else the clamped ones (JAX's `lax.cond`); its grid has room
//      for the longest span G allows (`gcap` blocks a tile).
//   3. `slab_nn_merge_kernel`, one thread a query: the span's partial
//      lists in block order with the same strict compares (the three
//      smallest by (distance, index) over the span, as the TPU kernel's
//      per-block top-3 and sorted merge give on either grid, both walking
//      a span's blocks upward from its start; an empty slot holds (1e38,
//      0)), then the certificate over the spans scanned: d2[2] <= margin^2
//      with margin the x-gap to the nearest unscanned key, clamped at 0.
//      A query that fails clears `proven[b]` and sets the call's fallback
//      flag, which K3's launches read on the card (the whole call falls
//      back, as JAX's `lax.cond` does), and the first to set it adds one
//      to a device count.  The flat form's merge writes the spans and
//      bounds it used into the call's span table.
//   Distances are diff-squares with explicit round-to-nearest intrinsics
//   in the JAX order.

#include <cuda_runtime.h>
#include <cstdint>

#include "three_nn.cuh"

namespace {

using three_nn::Best3;
using three_nn::kMaxPerThread;
using three_nn::kThreads;

constexpr int kTile = 256;    // queries per tile (the span table's unit)
constexpr int kScan = 1024;   // keys per span block
constexpr int kSpanWarps = 8;
constexpr float kBig = 1e38f;
constexpr unsigned kFull = 0xffffffffu;

// The count of keys x[0], x[3], ... (n of them, ascending) that are < v
// (`right` false: searchsorted left) or <= v (`right`: searchsorted
// right), found by the whole warp: 32 probes a step cut the range 32-fold.
__device__ __forceinline__ int warp_search(const float* __restrict__ x,
                                           int n, float v, bool right,
                                           int lane) {
  int lo = 0, hi = n;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    bool in = false;
    if (p < hi) {
      const float k = __ldg(x + 3 * (size_t)p);
      in = right ? k <= v : k < v;
    }
    const int c = __popc(__ballot_sync(kFull, in));  // a prefix of lanes
    if (c == 0) {
      hi = lo;
    } else {
      const int nlo = lo + (c - 1) * step + 1;
      hi = min(lo + c * step, hi);
      lo = nlo;
    }
  }
  return lo;
}

// A tile's span [start, stop) and the x of the nearest key outside it on
// either side (+-1e38 past the ends), at entry `o` of ss / lr [B, T, 2].
__device__ __forceinline__ void put_span(int32_t* ss, float* lr,
                                         const float* __restrict__ key,
                                         int nk, size_t o, int start,
                                         int stop) {
  ss[o] = start;
  ss[o + 1] = stop;
  const int left = start * kScan - 1, right = stop * kScan;
  lr[o] = left >= 0 ? key[3 * (size_t)left] : -kBig;
  lr[o + 1] = right < nk ? key[3 * (size_t)right] : kBig;
}

// The span table the scan and merge read: the unclamped one where the flat
// form's total of live (tile, block) pairs is at most `steps`, else `ss`.
__device__ __forceinline__ bool flat_taken(const int32_t* ssu,
                                           const int32_t* total, int steps) {
  return ssu != nullptr && *total <= steps;
}

__global__ void __launch_bounds__(kSpanWarps * 32)
slab_nn_span_kernel(const float* __restrict__ query,
                    const float* __restrict__ key, int32_t* __restrict__ ss,
                    float* __restrict__ lr, int32_t* __restrict__ ssu,
                    float* __restrict__ lru, int32_t* __restrict__ total,
                    bool* __restrict__ proven, int32_t* __restrict__ fallback,
                    int batch, int nq, int nk, int tiles, float bound,
                    int cap) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kSpanWarps + (threadIdx.x >> 5);
  if (w >= batch * tiles) return;
  const int b = w / tiles, t = w % tiles;
  if (t == 0 && lane == 0) {
    proven[b] = true;
    if (b == 0) *fallback = 0;
  }
  query += (size_t)b * nq * 3;
  key += (size_t)b * nk * 3;
  float mn = __int_as_float(0x7f800000), mx = -mn;
#pragma unroll
  for (int i = 0; i < kTile / 32; ++i) {
    const int q = t * kTile + i * 32 + lane;
    if (q < nq) {
      const float x = query[3 * (size_t)q];
      if (x < 1e9f) {  // pad queries would widen the range
        mn = fminf(mn, x);
        mx = fmaxf(mx, x);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  const bool any = mn <= mx;
  const float lo = any ? __fsub_rn(mn, bound) : 1e9f;
  const float hi = any ? __fadd_rn(mx, bound) : 1e9f;
  const int srow = warp_search(key, nk, lo, false, lane);
  const int erow = warp_search(key, nk, hi, true, lane);
  if (lane != 0) return;
  const int nkb = (nk + kScan - 1) / kScan;
  const int start_u = min(srow / kScan, nkb - 1);
  const int stop_u = min(max((erow + kScan - 1) / kScan, start_u + 1), nkb);
  int start = start_u, stop = stop_u;
  if (cap < nkb) {  // clamp to `cap` blocks, recentred on the slab
    const int mid = (srow + erow) / (2 * kScan);
    const int s_ctr = min(max(mid - cap / 2, 0), nkb - cap);
    if (stop_u - start_u > cap) start = s_ctr;
    stop = min(stop_u, start + cap);
  }
  const size_t o = ((size_t)b * tiles + t) * 2;
  put_span(ss, lr, key, nk, o, start, stop);
  if (ssu) {  // the flat form: the unclamped span and its share of the total
    put_span(ssu, lru, key, nk, o, start_u, stop_u);
    atomicAdd(total, stop_u - start_u);
  }
}

// Block x = ((tile * halves + half) * cap + j) * parts + h: queries
// [tile*256 + half*128*Q, +128*Q) (Q a thread, strided by 128) against
// part h of span block start + j.  Writes part p = j * parts + h of
// pidx / pdist [B, cap * parts, 3, tiles * 256].
template <int Q>
__global__ void __launch_bounds__(kThreads)
slab_nn_split_kernel(const float* __restrict__ query,
                     const float* __restrict__ key,
                     const int32_t* __restrict__ ss,
                     const int32_t* __restrict__ ssu,
                     const int32_t* __restrict__ total, int steps,
                     int32_t* __restrict__ pidx, float* __restrict__ pdist,
                     int nq, int nk, int tiles, int cap, int parts) {
  constexpr int halves = kTile / (kThreads * Q);
  const int b = blockIdx.y;
  int x = blockIdx.x;
  const int h = x % parts;
  x /= parts;
  const int j = x % cap;
  x /= cap;
  const int half = x % halves, tile = x / halves;
  const int32_t* s2 = (flat_taken(ssu, total, steps) ? ssu : ss)
                     + ((size_t)b * tiles + tile) * 2;
  const int kb = s2[0] + j;
  if (kb >= s2[1]) return;
  __shared__ float4 sk[three_nn::kChunk + 2 * three_nn::kStep];
  const int q0 = tile * kTile + half * kThreads * Q + threadIdx.x;
  query += (size_t)b * nq * 3;
  key += (size_t)b * nk * 3;
  float qx[Q], qy[Q], qz[Q];
  Best3 best[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    // a query past the end is scanned as a copy of the last, unwritten
    const int q = min(q0 + u * kThreads, nq - 1);
    qx[u] = query[3 * q];
    qy[u] = query[3 * q + 1];
    qz[u] = query[3 * q + 2];
    best[u].init(kBig);
  }
  const int sub = kScan / parts;
  const int k0 = kb * kScan + h * sub, k1 = min(k0 + sub, nk);
  // the x of the block's middle query (the queries are x-sorted)
  const float pivot = query[3 * min(q0 - threadIdx.x + kThreads * Q / 2,
                                    nq - 1)];
  three_nn::scan_keys_outward<Q>(sk, key, k0, k1, pivot, kBig, qx, qy, qz,
                                 best);
  const size_t mp = (size_t)tiles * kTile;
  const int p = j * parts + h;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int q = q0 + u * kThreads;
    if (q < nq)
      three_nn::put_part(pidx, pdist, ((size_t)b * cap * parts + p) * 3 * mp
                         + q, mp, best[u]);
  }
}

// One block a tile, one thread a query: the merge in block order, the
// result, and the certificate.
__global__ void __launch_bounds__(kTile)
slab_nn_merge_kernel(const float* __restrict__ query,
                     int32_t* __restrict__ ss, float* __restrict__ lr,
                     const int32_t* __restrict__ ssu,
                     const float* __restrict__ lru,
                     const int32_t* __restrict__ total, int steps,
                     const int32_t* __restrict__ pidx,
                     const float* __restrict__ pdist,
                     int32_t* __restrict__ idx, float* __restrict__ dist,
                     bool* __restrict__ proven,
                     int32_t* __restrict__ fallback,
                     unsigned long long* __restrict__ count, int nq,
                     int tiles, int cap, int parts) {
  const int b = blockIdx.y, t = blockIdx.x;
  const int q = t * kTile + threadIdx.x;
  const size_t o2 = ((size_t)b * tiles + t) * 2;
  const bool flat = flat_taken(ssu, total, steps);
  const int32_t* sp = flat ? ssu : ss;
  const float* lp = flat ? lru : lr;
  bool ok = true;
  if (q < nq) {
    const int live = (sp[o2 + 1] - sp[o2]) * parts;
    const size_t mp = (size_t)tiles * kTile;
    Best3 r;
    r.init(kBig);
#pragma unroll 4
    for (int p = 0; p < live; ++p) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const size_t o = (((size_t)b * cap * parts + p) * 3 + e) * mp + q;
        r.insert(pdist[o], pidx[o]);
      }
    }
    three_nn::put_part(idx, dist, ((size_t)b * nq + q) * 3, 1, r);
    // the nearest unscanned key on either side, by x alone; a clamped
    // span can leave a query outside its tile's window: margin 0.  NaN
    // propagates as in jnp.minimum / jnp.maximum (and then fails)
    const float qx = query[((size_t)b * nq + q) * 3];
    const float a = __fsub_rn(qx, lp[o2]), c = __fsub_rn(lp[o2 + 1], qx);
    float margin = (a != a) ? a : (a < c ? a : c);
    margin = margin < 0.f ? 0.f : margin;
    ok = r.d2 <= __fmul_rn(margin, margin);
  }
  const unsigned failed = __ballot_sync(kFull, !ok);
  if (failed && (threadIdx.x & 31) == 0) {
    proven[b] = false;
    if (atomicExch(fallback, 1) == 0 && count) atomicAdd(count, 1ull);
  }
  if (flat && threadIdx.x == 0) {  // the spans scanned, as the call's table
    ss[o2] = ssu[o2];
    ss[o2 + 1] = ssu[o2 + 1];
    lr[o2] = lru[o2];
    lr[o2 + 1] = lru[o2 + 1];
  }
}

template <int Q>
void split(dim3 grid, cudaStream_t stream, const float* query,
           const float* key, const int32_t* ss, const int32_t* ssu,
           const int32_t* total, int steps, int32_t* pidx, float* pdist,
           int nq, int nk, int tiles, int cap, int parts) {
  slab_nn_split_kernel<Q><<<grid, kThreads, 0, stream>>>(
      query, key, ss, ssu, total, steps, pidx, pdist, nq, nk, tiles, cap,
      parts);
}

// Both forms: `ssu`, `lru` and `total` null for the bounded one; `gcap`
// the split grid's blocks a tile (`cap` for the bounded form).
int three_nn_slab(const float* query, const float* key, int32_t* ss,
                  float* lr, int32_t* ssu, float* lru, int32_t* total,
                  int32_t* pidx, float* pdist, int32_t* idx, float* dist,
                  bool* proven, int32_t* fallback, unsigned long long* count,
                  int batch, int nq, int nk, float bound, int cap, int gcap,
                  int per_thread, int parts, cudaStream_t stream) {
  const int nkb = (nk + kScan - 1) / kScan;
  if (batch < 1 || nq < 1 || nk < 1 || cap < 1 || cap > nkb ||
      gcap < cap || gcap > nkb ||
      (per_thread != 1 && per_thread != kMaxPerThread) ||
      (parts != 1 && parts != 2 && parts != 4))
    return (int)cudaErrorInvalidValue;
  const int tiles = (nq + kTile - 1) / kTile;
  const int warps = batch * tiles;
  // JAX's G: the flat grid's steps (slab.py:899)
  const int steps = warps * 5 / 2;
  cudaError_t err = cudaSuccess;
  if (total) err = cudaMemsetAsync(total, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  slab_nn_span_kernel<<<(warps + kSpanWarps - 1) / kSpanWarps,
                        kSpanWarps * 32, 0, stream>>>(
      query, key, ss, lr, ssu, lru, total, proven, fallback, batch, nq, nk,
      tiles, bound, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int halves = kTile / (kThreads * per_thread);
  const dim3 grid(tiles * halves * gcap * parts, batch);
  if (per_thread == 1)
    split<1>(grid, stream, query, key, ss, ssu, total, steps, pidx, pdist,
             nq, nk, tiles, gcap, parts);
  else
    split<kMaxPerThread>(grid, stream, query, key, ss, ssu, total, steps,
                         pidx, pdist, nq, nk, tiles, gcap, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slab_nn_merge_kernel<<<dim3(tiles, batch), kTile, 0, stream>>>(
      query, ss, lr, ssu, lru, total, steps, pidx, pdist, idx, dist, proven,
      fallback, count, nq, tiles, gcap, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// query [B, Nq, 3], key [B, NK, 3] f32 (keys x-ascending) -> span table
// ss [B, T, 2] int32 (key blocks [start, stop) of each tile of 256
// queries), lr [B, T, 2] f32 (x of the nearest unscanned key left and
// right), idx [B, Nq, 3] int32, dist [B, Nq, 3] f32 squared distances
// ascending, proven [B] bool, fallback [1] int32 (1 where any cloud is
// unproven); `count` (may be null) int64 [1] gains one where a call falls
// back.  `cap` = min(grid_span, key blocks); `per_thread` (1 or 2) and
// `parts` (1, 2 or 4 parts a key block) from ops/slab.three_nn_slab_grid;
// pidx / pdist [B, cap * parts, 3, T * 256] are the split's scratch.
// cudaErrorInvalidValue for a grid the kernel does not take.
extern "C" int regnet_three_nn_slab(const float* query, const float* key,
                                    int32_t* ss, float* lr, int32_t* pidx,
                                    float* pdist, int32_t* idx, float* dist,
                                    bool* proven, int32_t* fallback,
                                    unsigned long long* count, int batch,
                                    int nq, int nk, float bound, int cap,
                                    int per_thread, int parts,
                                    cudaStream_t stream) {
  return three_nn_slab(query, key, ss, lr, nullptr, nullptr, nullptr, pidx,
                       pdist, idx, dist, proven, fallback, count, batch, nq,
                       nk, bound, cap, cap, per_thread, parts, stream);
}

// K8 flat (`three_nn_slab(flat=True)` where cap < key blocks): as above,
// with ssu / lru [B, T, 2] and total [1] int32 the unclamped span table,
// its bounds and its total of live (tile, block) pairs (scratch); `gcap`
// (cap .. key blocks) the split grid's blocks a tile, pidx / pdist
// [B, gcap * parts, 3, T * 256].  ss / lr come back as the spans scanned:
// the unclamped ones where their total is at most G = B*T*5/2, else the
// clamped ones, chosen on the card.
extern "C" int regnet_three_nn_slab_flat(
    const float* query, const float* key, int32_t* ss, float* lr,
    int32_t* ssu, float* lru, int32_t* total, int32_t* pidx, float* pdist,
    int32_t* idx, float* dist, bool* proven, int32_t* fallback,
    unsigned long long* count, int batch, int nq, int nk, float bound,
    int cap, int gcap, int per_thread, int parts, cudaStream_t stream) {
  if (!ssu || !lru || !total) return (int)cudaErrorInvalidValue;
  return three_nn_slab(query, key, ss, lr, ssu, lru, total, pidx, pdist,
                       idx, dist, proven, fallback, count, batch, nq, nk,
                       bound, cap, gcap, per_thread, parts, stream);
}

// K4 — max over gathered rows (region and refine pooling).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/pooling.py, gather_max_pallas
//   (_kernel, dispatched from ops/pooling.py:270 for the region pool at
//   models/regnet.py:270).
// Bound on the H100: memory traffic from L2.  The function's inputs are
//   the feature rows its indices touch (26 MB of features, which fit the
//   50 MB L2) and 4 MB of indices; but most slots repeat a row: the bucket
//   fill of K11 and K5 writes a region's first pick (slot 0's row) into
//   every empty slot, so at the region pool (4,000 x 256 slots x 256
//   channels) a row holds about 9 distinct rows of its 256 slots.  A
//   kernel that walks every slot reads 1 GB from L2 for 37 MB of distinct
//   rows.
// Design: the TPU kernel's one-hot matrix products and 3-way bf16 split
//   exist only because the TPU has no fast gather.  Here one warp owns one
//   (batch, proposal) row, 8 rows a block.  It loads the row's K indices
//   coalesced (8 a lane at K = 256) and keeps slot k when k == 0 or
//   index[k] != index[0] (`ops/pooling.kept_slots`): every dropped slot is
//   a later copy of slot 0's row, so neither the max nor the lowest slot
//   holding it changes, for any index tensor.  The kept slots are
//   compacted in slot order into shared memory with __ballot_sync and
//   __popc, and the warp walks the list reading each kept row with 16-byte
//   loads (256 channels are 64 float4, two a lane), 4 rows' loads in
//   flight, the max in registers.  The result is bit-exact (a max of
//   copied values); a NaN wins as in torch.amax.
//   Training uses the argmax form, which also writes the winner's source
//   row: the lowest slot holding the maximum (strict `>` while walking up
//   the kept slots), the rule of the TPU kernel's `with_argmax` output
//   (pooling.py:146-167) and of argmax-then-take (pooling.py:241-246).
//   The bf16 form (a bf16 compute dtype; JAX dispatches the TPU kernel's
//   bf16 branch, `terms = (fw,)`, pooling.py:124-125, from S*K*C >= 2^25,
//   :53) is the same kernel on 16-bit rows: a 16-byte load is 8 channels
//   (256 channels: one load a lane), each value compared as the f32 it
//   widens to exactly and copied bit for bit, so it equals the plain max
//   bit for bit (a NaN wins and stays, as in torch.amax; __hmax2 would
//   drop it).  Half the bytes of the f32 form, the same reads from L2.
//   The argmax forms (f32 and bf16: bf16 training) take a kept slot that
//   holds a larger value, or a NaN where the maximum so far is none, so a
//   NaN wins at its first slot as in torch.argmax and jnp.argmax
//   (pooling.py:243); a bf16 winner's value is copied bit for bit.
//   The backward, an XLA scatter-add in the JAX package (pooling.py:285-296),
//   is `scatter_winner_kernel`: dfeature[b, win[b,s,c], c] += g[b,s,c].  One
//   thread owns one (batch, channel) column and walks the S rows in order,
//   so no two threads touch one address and the sum order is fixed: the
//   gradient is deterministic, with no atomics.  It is bound by its S
//   dependent read-modify-writes per thread (64 at the training shape).
//   On bf16 (bf16 training) it sums as XLA's bf16 scatter-add does on the
//   CPU, `jnp.zeros(n*C, bf16).at[keys].add(g)`: in s order, each add
//   taken in f32 and rounded to nearest even bf16 (tests/
//   test_torch_port_train_bf16.py holds that rule against the JAX VJP).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;    // warps a block, one row each
constexpr int kPass = 256;          // slots a warp compacts at a time
constexpr int kInFlight = 4;        // kept rows whose loads are in flight
constexpr int kPassChannels = 256;  // channels a warp holds at a time
constexpr unsigned kFull = 0xffffffffu;

// Element types: float, and bf16 as its 16 raw bits (uint16_t), compared
// as the f32 it widens to and copied bit for bit.  Vec<E, V>: V elements
// a load (16 bytes: 4 floats or 8 bf16, where C is a multiple of V and
// the pointers are 16-byte aligned; else 1), W the winners of the argmax
// form (V ints).
template <typename E, int V>
struct Vec;
template <>
struct Vec<float, 4> {
  using T = float4;
  using W = int4;
};
template <>
struct Vec<float, 1> {
  using T = float;
  using W = int;
};
struct alignas(16) int8v {
  int4 lo, hi;
};
template <>
struct Vec<uint16_t, 8> {
  using T = uint4;
  using W = int8v;
};
template <>
struct Vec<uint16_t, 1> {
  using T = unsigned short;
  using W = int;
};

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float at(const float& v, int) { return v; }
__device__ __forceinline__ float at(const uint4& v, int i) {
  const unsigned w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float at(const unsigned short& v, int) {
  return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ void put(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void put(float& v, int, float x) { v = x; }
__device__ __forceinline__ void put(int4& v, int i, int x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void put(int& v, int, int x) { v = x; }
__device__ __forceinline__ void put(int8v& v, int i, int x) {
  put(i < 4 ? v.lo : v.hi, i & 3, x);
}

// m's element i := v's element i, bit for bit.
__device__ __forceinline__ void take(float4& m, const float4& v, int i) {
  put(m, i, at(v, i));
}
__device__ __forceinline__ void take(float& m, const float& v, int) {
  m = v;
}
__device__ __forceinline__ unsigned merge(unsigned d, unsigned s, int hi) {
  return hi ? (d & 0x0000ffffu) | (s & 0xffff0000u)
            : (d & 0xffff0000u) | (s & 0x0000ffffu);
}
__device__ __forceinline__ void take(uint4& m, const uint4& v, int i) {
  if (i < 2) m.x = merge(m.x, v.x, i & 1);
  else if (i < 4) m.y = merge(m.y, v.y, i & 1);
  else if (i < 6) m.z = merge(m.z, v.z, i & 1);
  else m.w = merge(m.w, v.w, i & 1);
}
__device__ __forceinline__ void take(unsigned short& m,
                                     const unsigned short& v, int) {
  m = v;
}

// Fold row `r`'s values `v` into the running max `m` (and winner `w`).
template <typename E, bool kArgmax, int V>
__device__ __forceinline__ void fold(typename Vec<E, V>::T& m,
                                     typename Vec<E, V>::W& w,
                                     const typename Vec<E, V>::T& v, int r) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float x = at(v, i), y = at(m, i);
    if (kArgmax) {
      if (x > y || (x != x && y == y)) {
        take(m, v, i);
        put(w, i, r);
      }
    } else if (x > y || x != x) {
      take(m, v, i);
    }
  }
}

// Slots [k0, k0 + kPass) of a row's K indices, slot k0 + lane + 32 j in
// v[j] (coalesced); -1 past the end.
__device__ __forceinline__ void load_slots(int* v,
                                           const int32_t* __restrict__ idx,
                                           int k0, int k_total, int lane) {
#pragma unroll
  for (int j = 0; j < kPass / 32; ++j) {
    const int k = k0 + j * 32 + lane;
    v[j] = k < k_total ? __ldg(idx + k) : -1;
  }
}

// Rows b*S + s of index [B, S, K] -> out [B, S, C] (and win [B, S, C]).
template <typename E, bool kArgmax, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
gather_max_kernel(const E* __restrict__ feature,
                  const int32_t* __restrict__ index, E* __restrict__ out,
                  int32_t* __restrict__ win, int n, int c_total, int s_total,
                  long long rows, int k_total) {
  using T = typename Vec<E, V>::T;
  using W = typename Vec<E, V>::W;
  constexpr int U = kPassChannels / (32 * V);
  __shared__ int kept[kRowsPerBlock][kPass];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the block syncs no more than a warp
  const int b = (int)(row / s_total);
  const int32_t* idx = index + row * k_total;
  const T* f = reinterpret_cast<const T*>(feature + (size_t)b * n * c_total);
  const int cv = c_total / V;  // loads a feature row
  int* list = kept[warp];
  // the first pass's indices, loaded before anything else: slot 0's row
  // comes from them
  int v[kPass / 32];
  load_slots(v, idx, 0, k_total, lane);
  const int first = __shfl_sync(kFull, v[0], 0);
  for (int c0 = 0; c0 < cv; c0 += 32 * U) {
    T m[U];
    W w[U];
    const T* r0 = f + (size_t)first * cv;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < cv) m[u] = __ldg(r0 + c);
      if (kArgmax) {
#pragma unroll
        for (int i = 0; i < V; ++i) put(w[u], i, first);
      }
    }
    for (int k0 = 0; k0 < k_total; k0 += kPass) {
      if (c0 > 0 || k0 > 0) load_slots(v, idx, k0, k_total, lane);
      // compact the kept slots of [k0, k0 + kPass) other than slot 0, in
      // slot order
      int count = 0;
#pragma unroll
      for (int j = 0; j < kPass / 32; ++j) {
        if (k0 + j * 32 >= k_total) break;
        const bool keep = v[j] != first && k0 + j * 32 + lane < k_total;
        const unsigned mask = __ballot_sync(kFull, keep);
        if (keep) list[count + __popc(mask & ((1u << lane) - 1u))] = v[j];
        count += __popc(mask);
      }
      __syncwarp();
      // groups of kInFlight rows, loads first; a group past the list's end
      // repeats its last row, which changes neither the max nor the winner
      for (int t = 0; t < count; t += kInFlight) {
        int r[kInFlight];
        T x[kInFlight][U];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          r[q] = list[min(t + q, count - 1)];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + u * 32 + lane;
            if (c < cv) x[q][u] = __ldg(f + (size_t)r[q] * cv + c);
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (c0 + u * 32 + lane < cv)
              fold<E, kArgmax, V>(m[u], w[u], x[q][u], r[q]);
      }
      __syncwarp();  // the list is rewritten by the next pass
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c >= cv) continue;
      reinterpret_cast<T*>(out + row * c_total)[c] = m[u];
      if (kArgmax) reinterpret_cast<W*>(win + row * c_total)[c] = w[u];
    }
  }
}

template <typename E, bool kArgmax>
int launch_gather_max(const E* feature, const int32_t* index, E* out,
                      int32_t* win, int batch, int n, int c_total, int s_total,
                      int k_total, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(E);  // elements a 16-byte load
  const long long rows = (long long)batch * s_total;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const uintptr_t bases = (uintptr_t)feature | (uintptr_t)out |
                          (kArgmax ? (uintptr_t)win : 0);
  const bool wide = c_total % kWide == 0 && bases % 16 == 0;
  if (wide)
    gather_max_kernel<E, kArgmax, kWide>
        <<<grid, kRowsPerBlock * 32, 0, stream>>>(
            feature, index, out, win, n, c_total, s_total, rows, k_total);
  else
    gather_max_kernel<E, kArgmax, 1><<<grid, kRowsPerBlock * 32, 0, stream>>>(
        feature, index, out, win, n, c_total, s_total, rows, k_total);
  return (int)cudaGetLastError();
}

// Element type of the backward: f32 adds in f32; bf16 (raw bits) adds in
// f32 and rounds each sum to nearest even bf16.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float((unsigned)x << 16);
}
__device__ __forceinline__ void narrow(float x, float* to) { *to = x; }
__device__ __forceinline__ void narrow(float x, uint16_t* to) {
  // round to nearest even; a NaN becomes torch's bf16 NaN, 0x7fc0
  const unsigned u = __float_as_uint(x);
  *to = x != x ? (uint16_t)0x7fc0u
               : (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// dfeature must be zero on entry.  Thread (b, c) adds g[b, s, c] to
// dfeature[b, win[b, s, c], c] for s = 0, 1, ... in order.
template <typename E>
__global__ void scatter_winner_kernel(const E* __restrict__ g,
                                      const int32_t* __restrict__ win,
                                      E* __restrict__ dfeature, int n,
                                      int c_total, int s_total) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_total) return;
  g += (size_t)b * s_total * c_total;
  win += (size_t)b * s_total * c_total;
  dfeature += (size_t)b * n * c_total;
  for (int s = 0; s < s_total; ++s) {
    const size_t at = (size_t)s * c_total + c;
    E* d = dfeature + (size_t)win[at] * c_total + c;
    narrow(widen(*d) + widen(g[at]), d);
  }
}

template <typename E>
int launch_backward(const E* g, const int32_t* win, E* dfeature, int batch,
                    int n, int c_total, int s_total, cudaStream_t stream) {
  const int threads = 64;
  dim3 grid((c_total + threads - 1) / threads, batch);
  scatter_winner_kernel<E><<<grid, threads, 0, stream>>>(g, win, dfeature,
                                                         n, c_total, s_total);
  return (int)cudaGetLastError();
}

}  // namespace

// feature [B, N, C] f32, index [B, S, K] int32 in [0, N) ->
// out [B, S, C] = max_k feature[b, index[b, s, k], c].
extern "C" int regnet_gather_max(const float* feature, const int32_t* index,
                                 float* out, int batch, int n, int c_total,
                                 int s_total, int k_total,
                                 cudaStream_t stream) {
  return launch_gather_max<float, false>(feature, index, out, nullptr, batch,
                                         n, c_total, s_total, k_total,
                                         stream);
}

// The same on bf16 features (their raw 16 bits): out [B, S, C] bf16, bit
// for bit the max of the gathered values.
extern "C" int regnet_gather_max_bf16(const uint16_t* feature,
                                      const int32_t* index, uint16_t* out,
                                      int batch, int n, int c_total,
                                      int s_total, int k_total,
                                      cudaStream_t stream) {
  return launch_gather_max<uint16_t, false>(feature, index, out, nullptr,
                                            batch, n, c_total, s_total,
                                            k_total, stream);
}

// The same, and win [B, S, C] int32 = index[b, s, k*] with k* the lowest
// slot holding the maximum.
extern "C" int regnet_gather_max_argmax(const float* feature,
                                        const int32_t* index, float* out,
                                        int32_t* win, int batch, int n,
                                        int c_total, int s_total, int k_total,
                                        cudaStream_t stream) {
  return launch_gather_max<float, true>(feature, index, out, win, batch, n,
                                        c_total, s_total, k_total, stream);
}

// The argmax form on bf16 features (their raw 16 bits): out bf16, the
// winner's value bit for bit.
extern "C" int regnet_gather_max_argmax_bf16(const uint16_t* feature,
                                             const int32_t* index,
                                             uint16_t* out, int32_t* win,
                                             int batch, int n, int c_total,
                                             int s_total, int k_total,
                                             cudaStream_t stream) {
  return launch_gather_max<uint16_t, true>(feature, index, out, win, batch,
                                           n, c_total, s_total, k_total,
                                           stream);
}

// g [B, S, C] f32, win [B, S, C] int32 in [0, N) -> dfeature [B, N, C],
// zero on entry: dfeature[b, win[b, s, c], c] += g[b, s, c], in s order.
extern "C" int regnet_gather_max_backward(const float* g, const int32_t* win,
                                          float* dfeature, int batch, int n,
                                          int c_total, int s_total,
                                          cudaStream_t stream) {
  return launch_backward<float>(g, win, dfeature, batch, n, c_total, s_total,
                                stream);
}

// The same on bf16 (raw bits): each add in f32, rounded to bf16, in s order.
extern "C" int regnet_gather_max_backward_bf16(const uint16_t* g,
                                               const int32_t* win,
                                               uint16_t* dfeature, int batch,
                                               int n, int c_total,
                                               int s_total,
                                               cudaStream_t stream) {
  return launch_backward<uint16_t>(g, win, dfeature, batch, n, c_total,
                                   s_total, stream);
}

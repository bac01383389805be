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
//   The backward, an XLA scatter-add in the JAX package (pooling.py:285-296,
//   slab.py:1090-1098), sums g[b, s, c] into dfeature[b, win[b, s, c], c]:
//   each entry the sum, in increasing s, of its contributions, from +0.0
//   (XLA's CPU scatter adds in update order into zeros; so does the plain
//   version).  On bf16 each add is taken in f32 and rounded to nearest even
//   bf16 (tests/test_torch_port_train_bf16.py holds that rule against the
//   JAX VJP).  Its bound is writing the dense dfeature ([12, 25,600, 256]
//   at the training pools: 314.6 MB f32, 157.3 MB bf16) against 1.6 MB of
//   g and win.  One owner a distinct output entry, the first s of its
//   winner in its (b, c) column, adds the column's contributions to it in s
//   order, in registers, and stores once: no atomic, no thread waits on
//   another's add, so the gradient is deterministic and equal to the plain
//   version bit for bit.  The sum starts at +0.0, never at the first g
//   (+0.0 + -0.0 = +0.0), and a NaN propagates (bf16: stored as 0x7fc0, as
//   torch rounds a NaN).  Two forms, by S:
//   - S <= kShortRows (the training pools, S = 64): `owners_short_kernel`
//     sorts each column's (winner, s) keys in a warp and writes its owners'
//     sums in row order, with offsets by chunk of rows, to a scratch buffer
//     kept in L2; `fill_owners_kernel`, launched to start as soon as the
//     owners have read their inputs (programmatic dependent launch), writes
//     dfeature once, 16 KB a block: zeros, then the owners' sums over them.
//     On an H100 a design that wrote dfeature first and the sums after it
//     paid a tail after the fill (the sums' lines had left L2 and the
//     fill's writes still drained), and a load issued while the fill's
//     stream of stores ran waited about as long as the fill.
//   - S > kShortRows (4,000 centers, on no path): `zero_fill_kernel`, then
//     `owners_sorted_kernel`: a block a column sorts its (winner, g) pairs
//     in shared memory (LSD radix on the winner, stable, 8 bits a pass), its
//     cluster of kClusterCols blocks reading the columns' rows together, and
//     each owner walks its run and stores its sum; past kSortRows rows a
//     segment continues from the sums the ones before stored.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

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
// sum + x as the element type adds: f32 as is, bf16 rounded to bf16
template <typename E>
__device__ __forceinline__ float accumulate(float sum, float x) {
  E r;
  narrow(sum + x, &r);
  return widen(r);
}

constexpr int kFillThreads = 512;    // threads a block of the plain fill
constexpr int kShortRows = 128;      // S up to this: the short form
constexpr int kOwnerCols = 8;        // columns an owners block, a warp each
constexpr int kWriterThreads = 256;  // threads a short-form writer block
constexpr int kWriterChannels = 256;  // channels it owns at most
constexpr int kBlockBytes = 16384;   // bytes of dfeature it owns
constexpr int kBlocksPerChunk = 8;   // such blocks a chunk of the offsets
constexpr int kSortThreads = 256;    // threads a sort-form block
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortRows = 4096;      // rows a sort-form block sorts at once
constexpr int kItems = kSortRows / kSortThreads;  // rows a thread holds
constexpr int kDigitBits = 8;        // winner bits a radix pass sorts
constexpr int kDigits = 1 << kDigitBits;
constexpr int kWalk = 8;             // entries an owner loads at a time
constexpr int kClusterCols = 2;      // columns a cluster of sort blocks reads
constexpr int kLoads = 8;            // loads a sort-form thread keeps in flight
static_assert(kDigits == kSortThreads, "the scan gives a digit a thread");

// Programmatic dependent launch (sm_90): the owners let the fill start
// early; the fill waits for the owners where it needs their lists.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prior() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// bytes [0, total) of `out` := 0, one 16-byte store a thread where aligned
// (block 0 also writes the unaligned head and tail): the sort form's fill,
// and the fill alone.
__global__ void __launch_bounds__(kFillThreads)
zero_fill_kernel(unsigned char* __restrict__ out, long long total) {
  const long long head =
      min((long long)((16 - ((uintptr_t)out & 15)) & 15), total);
  const long long vecs = (total - head) / 16;
  const long long tail = head + vecs * 16;
  const long long step = (long long)gridDim.x * blockDim.x;
  uint4* v = reinterpret_cast<uint4*>(out + head);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += step)
    v[i] = make_uint4(0, 0, 0, 0);
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) out[threadIdx.x] = 0;
    if (threadIdx.x < total - tail) out[tail + threadIdx.x] = 0;
  }
}

// An L2 policy that keeps the owners' lists in L2 through the fill's stream
// of stores, which reads them in every block (without it, a block's reads
// of them wait behind that stream).
__device__ __forceinline__ unsigned long long keep_in_l2() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void store_kept(unsigned long long* at,
                                           unsigned long long v,
                                           unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.b64 [%0], %1, %2;"
               :: "l"(at), "l"(v), "l"(policy) : "memory");
}
__device__ __forceinline__ void store_kept(int32_t* at, int32_t v,
                                           unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;"
               :: "l"(at), "r"(v), "l"(policy) : "memory");
}

// The owners of each column (b, c), in row order: list[b, c, i] = row << 32
// | the sum's f32 bits, and offset[b, k, c] = the column's owners of rows
// below k * chunk_rows, k = 0..chunks (the wrapper's scratch: [B, C, S]
// u64, [B, chunks + 1, C] int32).
struct Owners {
  unsigned long long* list;
  int32_t* offset;
};

// Short form, S <= 32 K <= kShortRows, first kernel: block (b, 8 channels)
// stages the [S x 8] tile of win and g in shared memory and lets the fill
// start (a load behind the fill's stream of stores waits about as long as
// the fill takes); a warp owns a column, a lane K of its rows.  The warp
// sorts the column's (winner, s) keys (a bitonic sort in registers:
// shuffles, and swaps within a lane), so a winner's rows are contiguous and
// in s order; the first of them owns the winner, walks its rows (a hot
// winner, as K9's unpicked regions put winner 0 in 50 of 64 rows, is one
// owner's ordinary walk: nothing is quadratic in a chain's length) and
// writes its sum at its place in the column's list; the lanes then write
// the column's chunk offsets.
template <typename E, int K>
__global__ void __launch_bounds__(kOwnerCols * 32)
owners_short_kernel(const E* __restrict__ g, const int32_t* __restrict__ win,
                    Owners own, int c_total, int s_total, int groups,
                    int chunk_rows, int chunks) {
  constexpr int P = 32 * K;  // sorted entries a column (padded)
  // one padding column: a lane's own row reads no bank twice
  __shared__ int keys[P][kOwnerCols + 1];
  __shared__ E vals[P][kOwnerCols + 1];
  __shared__ unsigned long long list[kOwnerCols][P];
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * kOwnerCols;
  const size_t base = (size_t)b * s_total * c_total + c0;
  for (int i = threadIdx.x; i < s_total * kOwnerCols; i += blockDim.x) {
    const int s = i / kOwnerCols, c = i % kOwnerCols;
    if (c0 + c < c_total) {
      const size_t at = base + (size_t)s * c_total + c;
      keys[s][c] = win[at];
      vals[s][c] = g[at];
    }
  }
  __syncthreads();
  let_next_start();
  const int col = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (c0 + col >= c_total) return;
  const unsigned lower = (1u << lane) - 1u;
  const unsigned long long policy = keep_in_l2();
  unsigned long long* a = list[col];
  unsigned long long e[K];  // entry r * 32 + lane; past S: after all
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = r * 32 + lane;
    e[r] = s < s_total ? (unsigned long long)(unsigned)keys[s][col] << 32 | s
                       : ~0ull;
  }
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const bool up = ((r * 32 + lane) & k) == 0;
        if (j >= 32) {  // the partner is entry r ^ (j / 32) of this lane
          const int q = r ^ (j >> 5);
          if (q > r && (e[r] > e[q]) == up) {
            const unsigned long long t = e[r];
            e[r] = e[q];
            e[q] = t;
          }
        } else {  // the partner is lane ^ j; the lower index keeps the min
          const unsigned long long o = __shfl_xor_sync(kFull, e[r], j);
          const bool keep_min = ((lane & j) == 0) == up;
          e[r] = keep_min ? (o < e[r] ? o : e[r]) : (o > e[r] ? o : e[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) a[r * 32 + lane] = e[r];
  __syncwarp();
  int before = 0;  // owners in the entries before this lane's round
  int place[K];
  float sum[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * 32 + lane;
    const unsigned key = (unsigned)(e[r] >> 32);
    const bool owner =
        i < s_total && (i == 0 || (unsigned)(a[i - 1] >> 32) != key);
    const unsigned mask = __ballot_sync(kFull, owner);
    place[r] = owner ? before + __popc(mask & lower) : -1;
    sum[r] = 0.0f;  // +0.0, as the zeros XLA adds to
    if (owner)
      for (int j = i; j < s_total && (unsigned)(a[j] >> 32) == key; ++j)
        sum[r] = accumulate<E>(sum[r], widen(vals[(unsigned)a[j]][col]));
    before += __popc(mask);
  }
  __syncwarp();  // every walk done: the owners replace the keys
  unsigned long long* out = own.list + ((size_t)b * c_total + c0 + col) *
                                           s_total;
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (place[r] >= 0) {
      const unsigned long long v =
          (e[r] & ~0xffffffffull) | __float_as_uint(sum[r]);
      a[place[r]] = v;
      store_kept(out + place[r], v, policy);
    }
  __syncwarp();
  // offset[k]: the owners of rows below k * chunk_rows (a binary search)
  int32_t* offset = own.offset + (size_t)b * (chunks + 1) * c_total + c0 + col;
  for (int k = lane; k <= chunks; k += 32) {
    const unsigned long long bound = (unsigned long long)k * chunk_rows;
    int lo = 0, hi = before;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if ((a[mid] >> 32) < bound) lo = mid + 1;
      else hi = mid;
    }
    store_kept(offset + (size_t)k * c_total, lo, policy);
  }
}

// Short form, second kernel, launched to start once the owners have read
// their inputs: block (b, row block, channel tile) owns dfeature[b, row0 +
// [0, block_rows), c0 + [0, kWriterChannels)], about kBlockBytes (a grid of
// such small blocks writes as fast as a plain fill).  It writes its zeros,
// 16 bytes a store (V channels; V = 1 where C is not a multiple of 16
// bytes), waits for the owners and, after the block's barrier, one thread
// a channel stores the sums of the channel's owners in its rows over their
// zeros while the lines are in L2 (it finds them from the column's offset
// of the chunk of kBlocksPerChunk blocks around them).  No line of
// dfeature is read back from DRAM.  `zero` 0: the sums alone, onto a
// dfeature that is zero.
template <typename E, int V>
__global__ void __launch_bounds__(kWriterThreads)
fill_owners_kernel(Owners own, E* __restrict__ dfeature, int n, int c_total,
                  int s_total, int chunks, int block_rows, int zero) {
  using Word = typename std::conditional<V == 1, E, uint4>::type;
  const int ctiles = (c_total + kWriterChannels - 1) / kWriterChannels;
  const int ct = blockIdx.x % ctiles, rest = blockIdx.x / ctiles;
  const int row_blocks = chunks * kBlocksPerChunk;
  const int b = rest / row_blocks, blk = rest - b * row_blocks;
  const int c0 = ct * kWriterChannels, cw = min(kWriterChannels, c_total - c0);
  const int row0 = blk * block_rows, rows = min(block_rows, n - row0);
  E* base = dfeature + ((size_t)b * n + row0) * c_total + c0;
  if (zero && rows > 0) {
    const int across = cw / V;  // words a row
    const Word nil{};
    for (int i = threadIdx.x; i < rows * across; i += kWriterThreads)
      reinterpret_cast<Word*>(base + (size_t)(i / across) * c_total)
          [i % across] = nil;
  }
  wait_for_prior();  // the owners' lists are complete
  __syncthreads();   // the block's zeros before the sums stored over them
  const int c = threadIdx.x;
  if (c >= cw || rows <= 0) return;
  const int32_t* offset = own.offset +
      ((size_t)b * (chunks + 1) + blk / kBlocksPerChunk) * c_total + c0 + c;
  const unsigned long long* list =
      own.list + ((size_t)b * c_total + c0 + c) * s_total;
  for (int j = offset[0], last = offset[c_total]; j < last; ++j) {
    const unsigned long long v = list[j];
    const int r = (int)(v >> 32) - row0;  // in increasing order
    if (r >= rows) break;
    if (r >= 0)
      narrow(__uint_as_float((unsigned)v), base + (size_t)r * c_total + c);
  }
}

// Sort form, S > kShortRows: a block owns column (b, c), a cluster of
// kClusterCols blocks the columns c0 + [0, kClusterCols).  The cluster
// reads its columns' rows together, kClusterCols channels a row (32 bytes
// in f32), each block a share of the rows, and stores each (winner, g)
// pair into its column's block (distributed shared memory).  A block sorts
// its column's pairs, kSortRows rows at a time, stably by winner (LSD
// radix, kDigitBits a pass, as many passes as n - 1 has bits), so each
// winner's run is contiguous and in s order; the run's first entry is its
// owner, which walks it and stores its sum into dfeature after the fill (a
// segment after the first continues from what the ones before stored; the
// cluster's barrier orders the two).
template <typename E>
__global__ void __cluster_dims__(kClusterCols, 1, 1)
    __launch_bounds__(kSortThreads)
owners_sorted_kernel(const E* __restrict__ g, const int32_t* __restrict__ win,
                     E* __restrict__ dfeature, int n, int c_total,
                     int s_total, int groups) {
  extern __shared__ unsigned long long buf[];  // [2][kSortRows], then ints
  int* offset = reinterpret_cast<int*>(buf + 2 * kSortRows);  // [warps][digits]
  int* warp_total = offset + kSortWarps * kDigits;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  const int cluster_id = blockIdx.x / kClusterCols;
  const int b = cluster_id / groups;
  const int c0 = (cluster_id - b * groups) * kClusterCols, c = c0 + rank;
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  E* d = dfeature + (size_t)b * n * c_total + c;
  for (int s0 = 0; s0 < s_total; s0 += kSortRows) {
    const int len = min(kSortRows, s_total - s0);
    const int rounds = (len + kSortThreads - 1) / kSortThreads;
    // the cluster's rows x channels, channel fastest; rows past `len` sort
    // last (winner 0xffffffff)
    const int cells = len * kClusterCols;
    constexpr int kStride = kClusterCols * kSortThreads;
    for (int k0 = rank * kSortThreads + threadIdx.x; k0 < cells;
         k0 += kLoads * kStride) {
      unsigned long long v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + u * kStride;
        const int row = k / kClusterCols, ch = k % kClusterCols;
        const size_t at = ((size_t)b * s_total + s0 + row) * c_total + c0 + ch;
        v[u] = k < cells && c0 + ch < c_total
                   ? (unsigned long long)(unsigned)win[at] << 32 |
                         __float_as_uint(widen(g[at]))
                   : ~0ull;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int k = k0 + u * kStride;
        if (k < cells)
          cluster.map_shared_rank(buf, k % kClusterCols)[k / kClusterCols] =
              v[u];
      }
    }
    for (int i = len + threadIdx.x; i < rounds * kSortThreads;
         i += kSortThreads)
      buf[i] = ~0ull;
    cluster.sync();  // every block holds its column
    if (c < c_total) {
      for (int p = 0; p < passes; ++p) {
        const unsigned long long* in = buf + (p & 1) * kSortRows;
        unsigned long long* out = buf + ((p + 1) & 1) * kSortRows;
        const int shift = 32 + p * kDigitBits;
        for (int i = threadIdx.x; i < kSortWarps * kDigits; i += kSortThreads)
          offset[i] = 0;
        __syncthreads();
        // each row's place among the warp's rows of its digit, in row
        // order: the lanes of equal digit from kDigitBits ballots
        unsigned long long item[kItems];
        int place[kItems];
#pragma unroll
        for (int r = 0; r < kItems; ++r) {
          if (r >= rounds) break;
          item[r] = in[(warp * rounds + r) * 32 + lane];
          const int digit = (int)(item[r] >> shift) & (kDigits - 1);
          unsigned same = kFull;
#pragma unroll
          for (int k = 0; k < kDigitBits; ++k) {
            const unsigned ones = __ballot_sync(kFull, (digit >> k) & 1);
            same &= (digit >> k) & 1 ? ones : ~ones;
          }
          int* at = offset + warp * kDigits + digit;
          const int before = *at;
          __syncwarp();
          if ((same & lower) == 0) *at = before + __popc(same);
          __syncwarp();
          place[r] = before + __popc(same & lower);
        }
        __syncthreads();
        // offsets in digit-major, warp-minor order: thread t owns digit t
        int run = 0;
#pragma unroll
        for (int w = 0; w < kSortWarps; ++w) {
          const int x = offset[w * kDigits + threadIdx.x];
          offset[w * kDigits + threadIdx.x] = run;
          run += x;
        }
        int upto = run;  // inclusive scan of the digit totals
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, upto, o);
          if (lane >= o) upto += y;
        }
        if (lane == 31) warp_total[warp] = upto;
        __syncthreads();
        int base = upto - run;
        for (int w = 0; w < warp; ++w) base += warp_total[w];
#pragma unroll
        for (int w = 0; w < kSortWarps; ++w)
          offset[w * kDigits + threadIdx.x] += base;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kItems; ++r) {
          if (r >= rounds) break;
          const int digit = (int)(item[r] >> shift) & (kDigits - 1);
          out[offset[warp * kDigits + digit] + place[r]] = item[r];
        }
        __syncthreads();
      }
      const unsigned long long* a = buf + (passes & 1) * kSortRows;
      for (int i = threadIdx.x; i < len; i += kSortThreads) {
        const unsigned key = (unsigned)(a[i] >> 32);
        if (i > 0 && (unsigned)(a[i - 1] >> 32) == key) continue;
        E* at = d + (size_t)key * c_total;
        // the first segment starts from +0.0, a later one from the sum the
        // ones before stored (the fill's +0.0 where none did)
        float sum = accumulate<E>(s0 == 0 ? 0.0f : widen(*at),
                                  __uint_as_float((unsigned)a[i]));
        for (int j = i + 1; j < len && (unsigned)(a[j] >> 32) == key;) {
          unsigned long long q[kWalk];  // the run, kWalk entries a load
          unsigned same = 0;            // bit u: entry j + u is in the run
#pragma unroll
          for (int u = 0; u < kWalk; ++u) {
            q[u] = j + u < len ? a[j + u] : ~0ull;
            same |= ((unsigned)(q[u] >> 32) == key) << u;
          }
#pragma unroll
          for (int u = 0; u < kWalk; ++u)
            if (same >> u & 1)
              sum = accumulate<E>(sum, __uint_as_float((unsigned)q[u]));
          j = same == (1u << kWalk) - 1 ? j + kWalk : len;
        }
        narrow(sum, at);
      }
    }
    cluster.sync();  // the next segment reads these sums, reuses buf
  }
}

// parts: kFill (dfeature := 0), kScatter (the scatter alone, onto a
// dfeature that is zero), or both.  `scratch`: the short form's owner
// lists and offsets.
constexpr int kFill = 1, kScatter = 2;

template <typename E>
int launch_backward(const E* g, const int32_t* win, E* dfeature,
                    int32_t* scratch, int batch, int n, int c_total,
                    int s_total, int parts, cudaStream_t stream) {
  const long long cells = (long long)batch * n * c_total;
  if (cells == 0) return (int)cudaGetLastError();
  const bool fill = parts & kFill, scatter = (parts & kScatter) && s_total;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  // launch `k` after the launch before it in the stream or, `early`, as
  // soon as that one lets it start
  auto run = [&](auto k, long long blocks, int threads, size_t smem,
                 bool early, auto... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = overlap;
    cfg.numAttrs = early ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, k, args...);
  };
  cudaError_t e = cudaSuccess;
  if (scatter && s_total <= kShortRows) {
    // the owners (their lists to `scratch`), then the writer, which starts
    // once the owners have read their inputs and stores the owners' sums
    const int cw = c_total < kWriterChannels ? c_total : kWriterChannels;
    const int fit = (int)(kBlockBytes / (cw * sizeof(E)));
    const int block_rows = fit > 1 ? fit : 1;
    const int chunk_rows = block_rows * kBlocksPerChunk;
    const int chunks = (n + chunk_rows - 1) / chunk_rows;
    const long long slots = (long long)batch * c_total * s_total;
    const Owners own = {reinterpret_cast<unsigned long long*>(scratch),
                        scratch + 2 * slots};
    const int groups = (c_total + kOwnerCols - 1) / kOwnerCols;
    void (*k1)(const E*, const int32_t*, Owners, int, int, int, int, int) =
        s_total <= 32   ? owners_short_kernel<E, 1>
        : s_total <= 64 ? owners_short_kernel<E, 2>
                        : owners_short_kernel<E, 4>;
    e = run(k1, (long long)batch * groups, kOwnerCols * 32, 0, false, g, win,
            own, c_total, s_total, groups, chunk_rows, chunks);
    if (e != cudaSuccess) return (int)e;
    constexpr int V = 16 / (int)sizeof(E);
    const bool wide = c_total % V == 0 && (uintptr_t)dfeature % 16 == 0;
    void (*k2)(Owners, E*, int, int, int, int, int, int) =
        wide ? fill_owners_kernel<E, V> : fill_owners_kernel<E, 1>;
    const int ctiles = (c_total + kWriterChannels - 1) / kWriterChannels;
    e = run(k2, (long long)batch * chunks * kBlocksPerChunk * ctiles,
            kWriterThreads, 0, true, own, dfeature, n, c_total, s_total,
            chunks, block_rows, fill ? 1 : 0);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  if (fill) {  // a block a 8 KB
    const long long bytes = cells * (long long)sizeof(E);
    zero_fill_kernel<<<(unsigned)(bytes / 16 / kFillThreads + 1),
                       kFillThreads, 0, stream>>>(
        reinterpret_cast<unsigned char*>(dfeature), bytes);
    e = cudaGetLastError();
    if (e != cudaSuccess || !scatter) return (int)e;
  }
  if (!scatter) return (int)cudaGetLastError();
  void (*k)(const E*, const int32_t*, E*, int, int, int, int) =
      owners_sorted_kernel<E>;
  const size_t smem = 2 * kSortRows * sizeof(unsigned long long) +
                      (kSortWarps * kDigits + kSortWarps) * sizeof(int);
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (c_total + kClusterCols - 1) / kClusterCols;
  e = run(k, (long long)batch * groups * kClusterCols, kSortThreads, smem,
          false, g, win, dfeature, n, c_total, s_total, groups);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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

// g [B, S, C] f32, win [B, S, C] int32 in [0, N) -> dfeature [B, N, C]:
// dfeature[b, r, c] = the sum over s, in order, from +0.0, of g[b, s, c]
// with win[b, s, c] == r.  scratch: the short form's owner lists, B * C *
// (2 * S + ceil(N / 128) + 1) int32 where S <= 128 (else unused).  `parts`
// 3 (the wrapper's): fill and scatter; 1: the zero fill alone; 2: the
// scatter alone, onto a dfeature that is zero (to time the two apart).
extern "C" int regnet_gather_max_backward(const float* g, const int32_t* win,
                                          float* dfeature, int32_t* scratch,
                                          int batch, int n, int c_total,
                                          int s_total, int parts,
                                          cudaStream_t stream) {
  return launch_backward<float>(g, win, dfeature, scratch, batch, n, c_total,
                                s_total, parts, stream);
}

// The same on bf16 (raw bits): each add in f32, rounded to bf16, in s order.
extern "C" int regnet_gather_max_backward_bf16(const uint16_t* g,
                                               const int32_t* win,
                                               uint16_t* dfeature,
                                               int32_t* scratch, int batch,
                                               int n, int c_total,
                                               int s_total, int parts,
                                               cudaStream_t stream) {
  return launch_backward<uint16_t>(g, win, dfeature, scratch, batch, n,
                                   c_total, s_total, parts, stream);
}

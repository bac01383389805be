// K13 — BatchNorm (+ ReLU + cast) over the trailing axis, six kernels:
//   K13a bn_stats_kernel            per-channel sum and sum of squares
//   K13b bn_apply_kernel            y = act(cast((x - mean) * mul + bias))
//   K13c bn_backward_reduce_kernel  per-channel sums of the gradient
//   K13d bn_backward_apply_kernel   dx
//   K13e bn_apply_max_kernel        K13b with ReLU and the max over the
//                                   neighbours, and the max's winners
//   K13f bn_max_backward_kernel     the max's gradient from its winners
//
// Replaces: no Pallas kernel.  The JAX package leaves `Dense -> BatchNorm
//   -> relu` (regnet_for_3d_grasping_tpu/nn/layers.py:40-45, flax's
//   BatchNorm and nn.relu) to XLA, which fuses the statistics into one
//   reduction and the normalisation, cast and ReLU into one elementwise
//   pass, forward and backward.  The port's plain version writes flax's
//   BatchNorm out op by op (nn/layers.py: `batch_statistics`,
//   `BatchNorm.forward`, `ConvBN.forward`); these kernels compute the same
//   function in one pass each.
// Bound on the H100: device memory.  Each kernel does a few operations a
//   value and reads (and K13b/K13d write) every value once: at SA1's
//   training shape (3,932,160 rows x 256 channels, 4.03 GB in f32) one
//   pass takes at least 1.2 ms at 3.35 TB/s.
// Layout: x is a contiguous channels-last [M, C] (M the product of the
//   leading axes), f32 or bf16; statistics, parameters and running
//   buffers are f32 [C].  Offsets are 64-bit: M * C passes 2^31.
// Design:
// - K13a and K13c reduce over rows.  A block covers a tile of channels
//   (128 bytes of a row where C allows: `lanes` threads of VEC channels,
//   16-byte loads) and the rows of one chunk, `256 / lanes` rows at a
//   time; every thread sums in f64, in row order, and the block adds its
//   threads' sums in a fixed tree.  Each block writes its partial sums;
//   the last block of a channel tile to finish (an integer ticket) adds
//   the tile's partials in chunk order and finishes the channel.  The grid
//   follows from M and C alone, so the sums are the same bits in every
//   run on every card (training is deterministic): no float atomics.  The
//   f64 sums of f32 or bf16 values and of their squares are exact but for
//   the last bits of a sum of millions, so K13a's mean and variance are
//   those of the f64 sums rounded once to f32.
// - K13b and K13d are elementwise over the flat [M * C] (VEC values a
//   thread, a grid-stride loop whose stride is a multiple of C, so each
//   thread keeps its channels' coefficients in registers).  They repeat the plain version's f32
//   operations in its order (flax's `(x - mean) * mul + bias`, never
//   `x * a + b`, with mul = rsqrtf(var + eps) * weight, torch's CUDA
//   rsqrt), and this source is compiled with -fmad=false, so given the
//   same statistics K13b equals the plain version bit for bit.
// - The backward recomputes the pre-ReLU value from x (never stored):
//   g' = g where cast(z) > 0 (torch's threshold_backward on the ReLU's
//   output), else 0.  K13c sums g' and g' * (x - mean) per channel and
//   finishes each channel's dweight, dbias and the two coefficients of
//   the statistics term (through the mean, and through the variance,
//   which is 0 where the clamp held the variance at 0), each in the f32
//   operations autograd takes on the plain version.  K13d writes
//   dx = g' * mul (frozen or eval statistics), and in train mode adds the
//   statistics term B * x + B * x + A: in f32 to the direct term, as
//   autograd accumulates x's four uses; on bf16 x each term is rounded to
//   bf16 first and their sum once more, as autograd casts the gradients
//   of `x - mean` and of `x.float()` to bf16 and adds them.
// - K13e and K13f serve the set-abstraction layers' max over neighbours
//   (JAX models/backbone.py:89-91, `jnp.max(h, axis=2)` of the last
//   ConvBN's ReLU, which XLA fuses into the normalisation).  x is then
//   [G, K, C], G groups of K <= 64 neighbours.  K13e reads each group's
//   K x C values once (a thread VEC channels of one group, 16-byte loads
//   along a row, the K rows in order), keeps each channel's running max
//   and a 64-bit word of the rows that reach it (a new max resets it, an
//   equal value sets its bit, -0.0 == +0.0; a NaN gives NaN and an empty
//   word, as torch's `amax` and its `y == max` mask do), and writes only
//   m [G, C] and the words: the [G, K, C] activation is never stored.
//   Bound: read x once, write m and the words (at SA1 of a batch of 12,
//   f32: 4.03 GB + 0.13 GB, 1.24 ms at 3.35 TB/s).  K13f expands the
//   gradient of m: g = bit_k ? q : q * 0 with q = g_m / popcount(word)
//   rounded to x's dtype, torch's `(grad / mask.sum()) * mask` (amax's
//   backward) value for value; it reads no activation and is bound by
//   the write of g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// One value of x: f32, or bf16 as its raw 16 bits.
template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// f32 -> T, rounded to nearest even (torch's `.to(torch.bfloat16)`).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// VEC values of T, loaded and stored at once (16 bytes at VEC * sizeof(T)
// = 16; C is a multiple of VEC).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p, int64_t i) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p + i);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, int64_t i,
                                      const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p + i) = v;
}

// torch.relu on the card: clamp_min(v, 0), a NaN kept.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The pre-ReLU value rounded to x's dtype, as the forward stores it before
// its ReLU, from the f32 operations of the plain version in its order.
template <typename T>
__device__ __forceinline__ float normalised(float x, float mean, float mul,
                                            float bias) {
  return to_f32<T>(from_f32<T>((x - mean) * mul + bias));
}

// The multiplier of a channel: torch's `rsqrt(var + eps) * weight` (var
// the batch variance clamped at 0 in train mode, the running one else).
__device__ __forceinline__ float multiplier(float var, float w, float eps,
                                            bool train) {
  return rsqrtf((train ? fmaxf(var, 0.0f) : var) + eps) * w;
}

// ---------------------------------------------------------------------------
// The row reductions (K13a, K13c): a block sums NS f64 sums for each of its
// tile's channels over its chunk of rows, writes them to `partial` [chunks,
// NS, C], and the tile's last block adds the chunks in order and finishes
// the channels with `Finish`.

struct Tile {
  int64_t rows;   // M
  int c;          // C
  int lanes;      // threads across a row of the tile (VEC channels each)
  int chunks;     // blocks along the rows (gridDim.y)
};

// Adds the block's per-thread sums `acc` [NS][VEC] over the threads of one
// lane (the rows in parallel) in a fixed tree; thread (row 0, lane) gets
// the block's sums.
template <int NS, int VEC>
__device__ __forceinline__ void block_sum(double (&acc)[NS][VEC],
                                          double* red, int lane, int row,
                                          int lanes, int rows_par) {
  const int slot = row * lanes + lane;
  for (int half = 1; half < rows_par; half <<= 1) {
    if ((row & (2 * half - 1)) == half) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[(slot * NS + s) * VEC + j] = acc[s][j];
    }
    __syncthreads();
    if ((row & (2 * half - 1)) == 0 && row + half < rows_par) {
      const int from = (row + half) * lanes + lane;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[s][j] += red[(from * NS + s) * VEC + j];
    }
    __syncthreads();
  }
}

// Sums the tile's rows of this block's chunk (`Term::sum_rows`: rows r0,
// r0 + step, ... below r1 of the VEC channels from c0, into acc), then, in
// the last block of the tile, the chunks, and calls `Term::finish` for
// each channel of the tile with its NS f64 sums.
template <int NS, int VEC, typename Term>
__device__ void reduce_rows(const Tile& t, const Term& term, double* partial,
                            unsigned int* ticket) {
  __shared__ double red[kThreads * NS * VEC];
  __shared__ bool last;
  const int lane = threadIdx.x % t.lanes;
  const int row = threadIdx.x / t.lanes;
  const int rows_par = kThreads / t.lanes;
  const int c0 = (blockIdx.x * t.lanes + lane) * VEC;
  const bool on = row < rows_par && c0 < t.c;
  const int64_t per = (t.rows + t.chunks - 1) / t.chunks;
  const int64_t r0 = per * blockIdx.y;
  const int64_t r1 = r0 + per < t.rows ? r0 + per : t.rows;

  double acc[NS][VEC];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[s][j] = 0.0;
  if (on) term.template sum_rows<VEC>(c0, r0 + row, r1, rows_par, acc);
  block_sum<NS, VEC>(acc, red, lane, row, t.lanes, rows_par);
  if (on && row == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        partial[(blockIdx.y * NS + s) * (int64_t)t.c + c0 + j] = acc[s][j];
  }
  // the last block of the tile (an integer ticket: the sums do not depend
  // on which block it is) adds the chunks' partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&ticket[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[s][j] = 0.0;
  if (on) {
    for (int k = row; k < t.chunks; k += rows_par)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[s][j] += __ldcg(&partial[(k * NS + s) * (int64_t)t.c + c0 + j]);
  }
  block_sum<NS, VEC>(acc, red, lane, row, t.lanes, rows_par);
  if (on && row == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      double sums[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) sums[s] = acc[s][j];
      term.finish(c0 + j, sums);
    }
  }
  if (threadIdx.x == 0) ticket[blockIdx.x] = 0;   // ready for the next call
}

// K13a: sum x and x^2; finish: stats [2, C] = mean, E[x^2] - mean^2 (f64,
// rounded once; not clamped: the backward reads the clamp from its sign),
// and, where asked, the running update in torch's order:
// running = running * keep + alpha * batch (the variance clamped).
template <typename T>
struct StatsTerm {
  const T* x;
  float* stats;
  float* running_mean;
  float* running_var;
  int64_t rows;
  int c;
  float keep, alpha;
  bool update;

  template <int VEC>
  __device__ __forceinline__ void sum_rows(int c0, int64_t r, int64_t r1,
                                           int step, double (&acc)[2][VEC])
      const {
    for (; r < r1; r += step) {
      const Pack<T, VEC> v = load<T, VEC>(x, r * c + c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const double d = static_cast<double>(to_f32<T>(v.v[j]));
        acc[0][j] += d;
        acc[1][j] += d * d;
      }
    }
  }

  __device__ __forceinline__ void finish(int ch, const double (&s)[2]) const {
    const double m = static_cast<double>(rows);
    const double mean = s[0] / m;
    const double var = s[1] / m - mean * mean;
    const float mean_f = static_cast<float>(mean);
    const float var_f = static_cast<float>(var);
    stats[ch] = mean_f;
    stats[c + ch] = var_f;
    if (update) {
      running_mean[ch] = __fmaf_rn(alpha, mean_f, running_mean[ch] * keep);
      running_var[ch] = __fmaf_rn(alpha, fmaxf(var_f, 0.0f),
                                  running_var[ch] * keep);
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(Tile t, StatsTerm<T> term, double* partial,
                    unsigned int* ticket) {
  reduce_rows<2, VEC>(t, term, partial, ticket);
}

// K13c: sum g' and g' * (x - mean) (the product in f32, as autograd forms
// it); finish: out [4, C] = dweight, dbias, and in train mode the
// statistics term's A (through the mean) and B (through the variance),
// each in autograd's f32 operations on the plain version:
//   dmul = sum g' (x - mean), r = rsqrt(var + eps), dweight = dmul * r,
//   dmean = -mul * sum g' + u + u with u = -dd * mean,
//   dd = (-0.5 * dmul * w) * r^3 where the variance before the clamp is
//   >= 0 (else 0), A = dmean / M, B = dd / M.
template <typename T>
struct GradTerm {
  const T* g;
  const T* x;
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float* out;
  int64_t rows;
  int c;
  float eps;
  bool train, act;

  template <int VEC>
  __device__ __forceinline__ void sum_rows(int c0, int64_t r, int64_t r1,
                                           int step, double (&acc)[2][VEC])
      const {
    float mu[VEC], mul[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mu[j] = mean[c0 + j];
      mul[j] = multiplier(var[c0 + j], weight[c0 + j], eps, train);
      b[j] = bias[c0 + j];
    }
    for (; r < r1; r += step) {
      const Pack<T, VEC> gv = load<T, VEC>(g, r * c + c0);
      const Pack<T, VEC> xv = load<T, VEC>(x, r * c + c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_f32<T>(xv.v[j]);
        float gz = to_f32<T>(gv.v[j]);
        if (act && normalised<T>(xf, mu[j], mul[j], b[j]) <= 0.0f)
          gz = 0.0f;
        acc[0][j] += static_cast<double>(gz);
        acc[1][j] += static_cast<double>(gz * (xf - mu[j]));
      }
    }
  }

  __device__ __forceinline__ void finish(int ch, const double (&s)[2]) const {
    const float v = var[ch];
    const float w = weight[ch];
    const float r = rsqrtf((train ? fmaxf(v, 0.0f) : v) + eps);
    const float mul = r * w;
    const float dmul = static_cast<float>(s[1]);
    out[ch] = dmul * r;
    out[c + ch] = static_cast<float>(s[0]);
    float a = 0.0f, b = 0.0f;
    if (train) {
      const float m = static_cast<float>(rows);
      const float dd = v >= 0.0f ? (-0.5f * (dmul * w)) * ((r * r) * r)
                                 : 0.0f;
      const float u = -dd * mean[ch];
      const float dmean =
          (static_cast<float>(-static_cast<double>(mul) * s[0]) + u) + u;
      a = dmean / m;
      b = dd / m;
    }
    out[2 * c + ch] = a;
    out[3 * c + ch] = b;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_backward_reduce_kernel(Tile t, GradTerm<T> term, double* partial,
                              unsigned int* ticket) {
  reduce_rows<2, VEC>(t, term, partial, ticket);
}

// ---------------------------------------------------------------------------
// The elementwise passes (K13b, K13d) over the flat [M * C], VEC values a
// thread in a grid-stride loop.  The grid's stride is a multiple of C (the
// wrapper's `apply_blocks`), so a thread keeps its VEC channels throughout
// and holds their coefficients in registers.

// K13b: y = act(cast((x - mean) * mul + bias)).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const float* mean, const float* var, const float* weight,
                    const float* bias, int64_t total, int c, float eps,
                    bool train, bool act) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * VEC;
  int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
              VEC;
  if (i >= total) return;
  const int c0 = static_cast<int>(i % c);
  float mu[VEC], mul[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[c0 + j];
    mul[j] = multiplier(var[c0 + j], weight[c0 + j], eps, train);
    b[j] = bias[c0 + j];
  }
  for (; i < total; i += stride) {
    const Pack<T, VEC> xv = load<T, VEC>(x, i);
    Pack<T, VEC> yv;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float z = normalised<T>(to_f32<T>(xv.v[j]), mu[j], mul[j], b[j]);
      if (act) z = relu(z);
      yv.v[j] = from_f32<T>(z);
    }
    store<T, VEC>(y, i, yv);
  }
}

// K13d: dx from g' (the mask recomputed), the direct term g' * mul, and in
// train mode the statistics term B * x + B * x + A (coef [4, C] from K13c).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_backward_apply_kernel(const T* __restrict__ g, const T* __restrict__ x,
                             T* __restrict__ dx, const float* mean,
                             const float* var, const float* weight,
                             const float* bias, const float* coef,
                             int64_t total, int c, float eps, bool train,
                             bool act) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * VEC;
  int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) *
              VEC;
  if (i >= total) return;
  const int c0 = static_cast<int>(i % c);
  float mu[VEC], mul[VEC], b[VEC], ca[VEC], cb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[c0 + j];
    mul[j] = multiplier(var[c0 + j], weight[c0 + j], eps, train);
    b[j] = bias[c0 + j];
    ca[j] = coef[2 * c + c0 + j];
    cb[j] = coef[3 * c + c0 + j];
  }
  for (; i < total; i += stride) {
    const Pack<T, VEC> gv = load<T, VEC>(g, i);
    const Pack<T, VEC> xv = load<T, VEC>(x, i);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xf = to_f32<T>(xv.v[j]);
      float gz = to_f32<T>(gv.v[j]);
      if (act && normalised<T>(xf, mu[j], mul[j], b[j]) <= 0.0f) gz = 0.0f;
      const float direct = gz * mul[j];
      if (!train) {
        out.v[j] = from_f32<T>(direct);
        continue;
      }
      const float t = cb[j] * xf;
      if (sizeof(T) == 4) {
        out.v[j] = from_f32<T>(((direct + t) + t) + ca[j]);
      } else {
        const float stat = to_f32<T>(from_f32<T>((t + t) + ca[j]));
        out.v[j] = from_f32<T>(to_f32<T>(from_f32<T>(direct)) + stat);
      }
    }
    store<T, VEC>(dx, i, out);
  }
}

// K13e: per group g and channel, m = max over k of
// relu(cast((x[g, k] - mean) * mul + bias)) (K13b's value bit for bit) and
// the word of the k that reach it.  A thread takes VEC channels of one
// group; a warp reads 32 x 16 bytes of a row at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_max_kernel(const T* __restrict__ x, T* __restrict__ m,
                        unsigned long long* __restrict__ win,
                        const float* mean, const float* var,
                        const float* weight, const float* bias,
                        int64_t groups, int k, int c, float eps,
                        bool train) {
  const int nvec = c / VEC;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups * nvec) return;
  const int64_t g = t / nvec;
  const int c0 = static_cast<int>(t - g * nvec) * VEC;
  float mu[VEC], mul[VEC], b[VEC], best[VEC], nan_value[VEC];
  unsigned long long word[VEC];
  bool nan[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mu[j] = mean[c0 + j];
    mul[j] = multiplier(var[c0 + j], weight[c0 + j], eps, train);
    b[j] = bias[c0 + j];
    best[j] = 0.0f;
    nan_value[j] = 0.0f;
    word[j] = 0ull;
    nan[j] = false;
  }
  const T* row = x + g * k * c + c0;
#pragma unroll 4
  for (int i = 0; i < k; ++i) {
    const Pack<T, VEC> xv = load<T, VEC>(row, static_cast<int64_t>(i) * c);
    const unsigned long long bit = 1ull << i;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v =
          relu(normalised<T>(to_f32<T>(xv.v[j]), mu[j], mul[j], b[j]));
      if (i == 0 || v > best[j]) {
        best[j] = v;
        word[j] = bit;
      } else if (v == best[j]) {
        word[j] |= bit;
      }
      if (isnan(v) && !nan[j]) {
        nan[j] = true;
        nan_value[j] = v;
      }
    }
  }
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    out.v[j] = from_f32<T>(nan[j] ? nan_value[j] : best[j]);
    if (nan[j]) word[j] = 0ull;
  }
  store<T, VEC>(m, g * c + c0, out);
  if (win != nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) win[g * c + c0 + j] = word[j];
  }
}

// K13f: g[g, k] = bit_k(word) ? q : q * 0, q = cast(g_m / popcount(word))
// (torch's f32 division; a word of 0 gives q = g_m / 0 and NaN at every
// k, as amax's backward does).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_max_backward_kernel(const T* __restrict__ gm,
                           const unsigned long long* __restrict__ win,
                           T* __restrict__ gx, int64_t groups, int k,
                           int c) {
  const int nvec = c / VEC;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups * nvec) return;
  const int64_t g = t / nvec;
  const int c0 = static_cast<int>(t - g * nvec) * VEC;
  const Pack<T, VEC> gv = load<T, VEC>(gm, g * c + c0);
  float q[VEC];
  unsigned long long word[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    word[j] = win[g * c + c0 + j];
    q[j] = to_f32<T>(from_f32<T>(
        to_f32<T>(gv.v[j]) / static_cast<float>(__popcll(word[j]))));
  }
  T* row = gx + g * k * c + c0;
#pragma unroll 4
  for (int i = 0; i < k; ++i) {
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      out.v[j] = from_f32<T>(q[j] * ((word[j] >> i) & 1ull ? 1.0f : 0.0f));
    store<T, VEC>(row, static_cast<int64_t>(i) * c, out);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers: `vec` is 8 (bf16) or 4 (f32) where C allows 16-byte
// loads, 4 (bf16, 8-byte loads) or 1 else; the wrapper picks it and the
// grid (`ops/batch_norm.tile_grid`).

template <typename T, template <typename, int> class K, typename... A>
int run_vec(int vec, dim3 grid, size_t smem, cudaStream_t stream,
            A... args) {
  switch (vec) {
    case 1:
      K<T, 1>::run(grid, smem, stream, args...);
      break;
    case 4:
      K<T, 4>::run(grid, smem, stream, args...);
      break;
    case 8:   // 16 bytes of bf16
      if constexpr (sizeof(T) == 2) {
        K<T, 8>::run(grid, smem, stream, args...);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
struct StatsK {
  static void run(dim3 g, size_t s, cudaStream_t st, Tile t, StatsTerm<T> term,
                  double* p, unsigned int* k) {
    bn_stats_kernel<T, VEC><<<g, kThreads, s, st>>>(t, term, p, k);
  }
};

template <typename T, int VEC>
struct GradK {
  static void run(dim3 g, size_t s, cudaStream_t st, Tile t, GradTerm<T> term,
                  double* p, unsigned int* k) {
    bn_backward_reduce_kernel<T, VEC><<<g, kThreads, s, st>>>(t, term, p, k);
  }
};

template <typename T, int VEC>
struct ApplyK {
  static void run(dim3 g, size_t s, cudaStream_t st, const void* x, void* y,
                  const float* mean, const float* var, const float* w,
                  const float* b, int64_t total, int c, float eps, bool train,
                  bool act) {
    bn_apply_kernel<T, VEC><<<g, kThreads, s, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, var, w, b, total,
        c, eps, train, act);
  }
};

template <typename T, int VEC>
struct BackK {
  static void run(dim3 g, size_t s, cudaStream_t st, const void* gr,
                  const void* x, void* dx, const float* mean,
                  const float* var, const float* w, const float* b,
                  const float* coef, int64_t total, int c, float eps,
                  bool train, bool act) {
    bn_backward_apply_kernel<T, VEC><<<g, kThreads, s, st>>>(
        static_cast<const T*>(gr), static_cast<const T*>(x),
        static_cast<T*>(dx), mean, var, w, b, coef, total, c, eps, train,
        act);
  }
};

template <typename T, int VEC>
struct MaxK {
  static void run(dim3 g, size_t s, cudaStream_t st, const void* x, void* m,
                  unsigned long long* win, const float* mean,
                  const float* var, const float* w, const float* b,
                  int64_t groups, int k, int c, float eps, bool train) {
    bn_apply_max_kernel<T, VEC><<<g, kThreads, s, st>>>(
        static_cast<const T*>(x), static_cast<T*>(m), win, mean, var, w, b,
        groups, k, c, eps, train);
  }
};

template <typename T, int VEC>
struct MaxBackK {
  static void run(dim3 g, size_t s, cudaStream_t st, const void* gm,
                  const unsigned long long* win, void* gx, int64_t groups,
                  int k, int c) {
    bn_max_backward_kernel<T, VEC><<<g, kThreads, s, st>>>(
        static_cast<const T*>(gm), win, static_cast<T*>(gx), groups, k, c);
  }
};

// One thread per group and VEC channels.
dim3 group_grid(int64_t groups, int c, int vec) {
  return dim3(static_cast<unsigned int>(
      (groups * (c / vec) + kThreads - 1) / kThreads));
}

constexpr int kMaxNeighbours = 64;   // the bits of a winners word

}  // namespace

// K13a.  x [rows, c] (f32, or bf16 raw bits where bf16 != 0) -> stats
// [2, c] f32 (mean, variance before the clamp); partial [chunks, 2, c] f64
// scratch; ticket [ceil(c / (lanes * vec))] uint32, zero before the call
// and after it.  update != 0: running_mean / running_var [c] updated.
extern "C" int regnet_bn_stats(const void* x, float* stats,
                               float* running_mean, float* running_var,
                               double* partial, unsigned int* ticket,
                               long long rows, int c, int vec, int lanes,
                               int chunks, int update, float keep,
                               float alpha, int bf16, cudaStream_t stream) {
  const Tile t{rows, c, lanes, chunks};
  const dim3 grid((c / vec + lanes - 1) / lanes, chunks);
  if (bf16) {
    const StatsTerm<uint16_t> term{static_cast<const uint16_t*>(x), stats,
                                   running_mean, running_var, rows, c, keep,
                                   alpha, update != 0};
    return run_vec<uint16_t, StatsK>(vec, grid, 0, stream, t, term, partial,
                                     ticket);
  }
  const StatsTerm<float> term{static_cast<const float*>(x), stats,
                              running_mean, running_var, rows, c, keep, alpha,
                              update != 0};
  return run_vec<float, StatsK>(vec, grid, 0, stream, t, term, partial,
                                ticket);
}

// K13b.  x [rows, c] -> y [rows, c], same dtype; mean, var, weight, bias
// [c] f32 (train != 0: the batch's statistics from K13a, the variance
// clamped at 0 here; else the running ones as they are); act != 0: ReLU.
// blocks * 256 * vec must be a multiple of c.
extern "C" int regnet_bn_apply(const void* x, void* y, const float* mean,
                               const float* var, const float* weight,
                               const float* bias, long long rows, int c,
                               int vec, int blocks, int train, int act,
                               float eps, int bf16, cudaStream_t stream) {
  if (static_cast<int64_t>(blocks) * kThreads * vec % c != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(rows) * c;
  if (bf16)
    return run_vec<uint16_t, ApplyK>(vec, dim3(blocks), 0, stream, x, y, mean,
                                     var, weight, bias, total, c, eps,
                                     train != 0, act != 0);
  return run_vec<float, ApplyK>(vec, dim3(blocks), 0, stream, x, y, mean, var,
                                weight, bias, total, c, eps, train != 0,
                                act != 0);
}

// K13c.  g, x [rows, c] -> out [4, c] f32: dweight, dbias, A, B (A = B = 0
// unless train); mean, var as K13b's (train: var before the clamp).
extern "C" int regnet_bn_backward_reduce(
    const void* g, const void* x, const float* mean, const float* var,
    const float* weight, const float* bias, float* out, double* partial,
    unsigned int* ticket, long long rows, int c, int vec, int lanes,
    int chunks, int train, int act, float eps, int bf16,
    cudaStream_t stream) {
  const Tile t{rows, c, lanes, chunks};
  const dim3 grid((c / vec + lanes - 1) / lanes, chunks);
  if (bf16) {
    const GradTerm<uint16_t> term{
        static_cast<const uint16_t*>(g), static_cast<const uint16_t*>(x),
        mean, var, weight, bias, out, rows, c, eps, train != 0, act != 0};
    return run_vec<uint16_t, GradK>(vec, grid, 0, stream, t, term, partial,
                                    ticket);
  }
  const GradTerm<float> term{static_cast<const float*>(g),
                             static_cast<const float*>(x), mean, var, weight,
                             bias, out, rows, c, eps, train != 0, act != 0};
  return run_vec<float, GradK>(vec, grid, 0, stream, t, term, partial,
                               ticket);
}

// K13d.  g, x [rows, c] -> dx [rows, c], x's dtype; coef [4, c] from K13c.
extern "C" int regnet_bn_backward_apply(
    const void* g, const void* x, void* dx, const float* mean,
    const float* var, const float* weight, const float* bias,
    const float* coef, long long rows, int c, int vec, int blocks, int train,
    int act, float eps, int bf16, cudaStream_t stream) {
  if (static_cast<int64_t>(blocks) * kThreads * vec % c != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(rows) * c;
  if (bf16)
    return run_vec<uint16_t, BackK>(vec, dim3(blocks), 0, stream, g, x, dx,
                                    mean, var, weight, bias, coef, total, c,
                                    eps, train != 0, act != 0);
  return run_vec<float, BackK>(vec, dim3(blocks), 0, stream, g, x, dx, mean,
                               var, weight, bias, coef, total, c, eps,
                               train != 0, act != 0);
}

// K13e.  x [groups, k, c] (f32, or bf16 raw bits where bf16 != 0) -> m
// [groups, c] in x's dtype and, where win is not null, the winners words
// [groups, c] (bit i: row i reaches the max); mean, var, weight, bias as
// K13b's; always with the ReLU.  0 < k <= 64.
extern "C" int regnet_bn_apply_max(const void* x, void* m,
                                   unsigned long long* win,
                                   const float* mean, const float* var,
                                   const float* weight, const float* bias,
                                   long long groups, int k, int c, int vec,
                                   int train, float eps, int bf16,
                                   cudaStream_t stream) {
  if (k <= 0 || k > kMaxNeighbours || c % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = group_grid(groups, c, vec);
  if (bf16)
    return run_vec<uint16_t, MaxK>(vec, grid, 0, stream, x, m, win, mean,
                                   var, weight, bias,
                                   static_cast<int64_t>(groups), k, c, eps,
                                   train != 0);
  return run_vec<float, MaxK>(vec, grid, 0, stream, x, m, win, mean, var,
                              weight, bias, static_cast<int64_t>(groups), k,
                              c, eps, train != 0);
}

// K13f.  g_m [groups, c] and the winners words [groups, c] from K13e ->
// g [groups, k, c], g_m's dtype.
extern "C" int regnet_bn_max_backward(const void* gm,
                                      const unsigned long long* win,
                                      void* gx, long long groups, int k,
                                      int c, int vec, int bf16,
                                      cudaStream_t stream) {
  if (k <= 0 || k > kMaxNeighbours || c % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = group_grid(groups, c, vec);
  if (bf16)
    return run_vec<uint16_t, MaxBackK>(vec, grid, 0, stream, gm, win, gx,
                                       static_cast<int64_t>(groups), k, c);
  return run_vec<float, MaxBackK>(vec, grid, 0, stream, gm, win, gx,
                                  static_cast<int64_t>(groups), k, c);
}

// K11 — fused radius grouping of the proposal regions (full scan).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/group_pallas.py,
//   group_regions_pallas (_group_kernel, group_pallas.py:119, dispatched
//   from geometry/region.py:149-158).
// Bound on the H100: arithmetic.  An exact radius test of a (center,
//   point) pair needs dx, its square and one compare (3 operations): the
//   rounded sum of squares is at least dx*dx, so dx*dx > r2 rules a pair
//   out.  Only a pair inside that slab needs dy, dz, their squares, the two
//   adds and the compare (7 more), and every pair in radius the counter
//   hash and its place in the bucket's argmax (10 more); the inputs are a
//   few hundred KB and the output M*K indices.  At 4,000 centers x 25,600
//   points that is 102 M pairs, at the training shape (12 clouds x 64
//   centers) 19.7 M.
// Design: the center-tiled bucket scan of bucket_scan.cuh with its radius
//   test (d2 <= r2, 8 centers per warp) and the hash pick.  The TPU
//   kernel's sequential grid carried count and first-winner accumulators
//   over [128 centers, L] tiles; here a block owns a tile of centers x a
//   range of buckets, writes each slot it owns and a partial count, and a
//   fill pass sums the counts and fills the empty buckets.  Testing dx
//   alone first, to skip the rest when no lane passes, ran slower: it
//   breaks the interleaving of the 8 centers.
//   Differences and squares are rounded one by one, in the JAX order
//   ((dx*dx + dy*dy) + dz*dz, d = center - point), so the radius test
//   agrees with the reference column for column.

#include <climits>

#include "bucket_scan.cuh"

using RadiusTest = bucket_scan::BallTest<false>;  // d2 <= r2

// xyz [B, N, 3], centers [B, M, 3] f32, u32 seed -> idx [B, M, K] int32 (0
// where a center has no point in radius), count [B, M] int32, the exact
// in-radius population; partial [B, M, ranges] int32 scratch.  Bucket k
// covers columns [k*L, (k+1)*L); in radius means d2 <= r2.  A block owns
// `tile` centers x `range` buckets (ops/bucket_scan.scan_grid).
extern "C" int regnet_group_regions(const float* xyz, const float* centers,
                                    uint32_t seed, int32_t* idx,
                                    int32_t* count, int32_t* partial,
                                    int batch, int n, int m_total,
                                    int k_total, int bucket, int tile,
                                    int range, float r2,
                                    cudaStream_t stream) {
  return bucket_scan::launch<RadiusTest, bucket_scan::HashPick>(
      xyz, nullptr, centers, seed, idx, count, partial, batch, n, m_total,
      k_total, bucket, tile, range, INT_MAX,
      bucket_scan::Params{{r2, 0.f, 0.f, 0.f}}, stream);
}

// The scan's constants that ops/bucket_scan.scan_grid needs: centers per
// warp and the most columns a block stages.  They launch nothing.
extern "C" int regnet_group_regions_per_warp() { return RadiusTest::kPerWarp; }
extern "C" int regnet_group_regions_stage_cols() {
  return bucket_scan::kMaxStageCols;
}

// K12 — the served radius grouping of the proposal regions (full scan): the
// JAX package's own function.
//
// Replaces: regnet_for_3d_grasping_tpu/geometry/region.py:160-185, the
//   chunked XLA path of group_regions that the JAX package runs on every
//   backend (its Pallas grouping is off, region.py:302-312).
// Bound on the H100: arithmetic.  The expansion-form distance rounds
//   differently from the difference form, so no slab of dx rules a pair
//   out: every (center, point) pair costs the cross term (a product and
//   two fused multiply-adds), -2 cross + |c|^2 (one more), + |p|^2 and the
//   compare (6), and every pair in radius the lowbias32 hash, its float
//   and its place in the bucket's argmax (13).  |p|^2 is a point's, shared
//   by the 8 centers of a warp.
// Design: the bucket scan of bucket_scan.cuh with the expansion test and
//   the chunked hash as its Test and Pick.  Buckets are ceil(N / K)
//   columns, 100 at 25,600 points and K = 256 (not a multiple of 32), so
//   a bucket is staged 128 slots apart with NaN in the pad.  The scores
//   are JAX's `hash_uniform` over a chunk's [B, chunk, N] linear index
//   (b*chunk + m % chunk)*N + n and the chunk's seed (one per `chunk`
//   centers), mixed in uint32 and compared as the f32 that the mix
//   rounds to, so that two hashes that round to one float tie and the
//   first column wins, as argmax over the uniforms does.
namespace {

// d2 <= r2 (p.v[0]) with d2 = (|c|^2 - 2 cross) + |p|^2 clamped at 0 and
// cross = fma(cz, pz, fma(cy, py, cx*px)): ops/distances.bpdist2, the JAX
// CPU order (the clamp changes no answer: r2 >= 0).  |c|^2 and |p|^2 are
// (x*x + y*y) + z*z.  -2 cross + |c|^2 in one fused multiply-add rounds
// as the product's exact 2 cross subtracted.
struct ExpansionTest {
  static constexpr int kPerWarp = 8;
  static constexpr int kUnroll = 2, kMinBlocks = 3;
  float cx, cy, cz, c2;
  static __device__ __forceinline__ float norm2(float x, float y, float z) {
    return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                     __fmul_rn(z, z));
  }
  __device__ __forceinline__ void load(const float*, const float* centers,
                                       size_t row) {
    cx = centers[row * 3];
    cy = centers[row * 3 + 1];
    cz = centers[row * 3 + 2];
    c2 = norm2(cx, cy, cz);
  }
  __device__ __forceinline__ bool operator()(
      float x, float y, float z, const bucket_scan::Params& p) const {
    const float cross =
        __fmaf_rn(cz, z, __fmaf_rn(cy, y, __fmul_rn(cx, x)));
    return __fadd_rn(__fmaf_rn(-2.f, cross, c2), norm2(x, y, z)) <= p.v[0];
  }
};

// ops/sampling.hash_uniform's score of column j of center m in cloud b:
// the lowbias32 mix of idx*2654435761 + seed*0x9E3779B9, idx the chunk's
// linear index, as the f32 it rounds to (its bits order as the floats)
struct ChunkHash {
  static __device__ __forceinline__ uint32_t row(const bucket_scan::Rows& r,
                                                 int b, int m, uint32_t,
                                                 int n) {
    // a row past the last center (a copy of it, never written) keeps to
    // the last chunk's seed
    const int k = min(m / r.chunk, r.chunks - 1);
    const uint32_t lin =
        ((uint32_t)b * (uint32_t)r.chunk + (uint32_t)(m - k * r.chunk)) *
        (uint32_t)n;
    return lin * 2654435761u + r.seeds[k] * 0x9E3779B9u;
  }
  static __device__ __forceinline__ uint32_t score(uint32_t row, int j) {
    uint32_t x = row + (uint32_t)j * 2654435761u;
    x ^= x >> 16;
    x *= 0x45D9F3Bu;
    x ^= x >> 16;
    x *= 0x45D9F3Bu;
    x ^= x >> 16;
    return __float_as_uint(__uint2float_rn(x));
  }
};

}  // namespace

// xyz [B, N, 3], centers [B, M, 3] f32, seeds [chunks] u32 on the host (one
// per `chunk` centers, at most kMaxChunks) -> idx [B, M, K] int32 (0 where a
// center has no point in radius), count [B, M] int32; partial [B, M,
// ranges] int32 scratch.  Bucket k covers columns [k*L, (k+1)*L), L =
// ceil(N / K); in radius means the expansion-form d2 <= r2.  A block owns
// `tile` centers x `range` buckets (ops/bucket_scan.scan_grid with L
// staged as a multiple of 32).  B*chunk*N must stay below 2^32 (the hash's
// u32 counter).
extern "C" int regnet_group_regions_chunked(
    const float* xyz, const float* centers, const uint32_t* seeds, int chunk,
    int chunks, int32_t* idx, int32_t* count, int32_t* partial, int batch,
    int n, int m_total, int k_total, int bucket, int tile, int range,
    float r2, cudaStream_t stream) {
  if (chunks < 1 || chunks > bucket_scan::kMaxChunks)
    return (int)cudaErrorInvalidValue;
  bucket_scan::Rows rows{{}, chunk, chunks};
  for (int i = 0; i < chunks; ++i) rows.seeds[i] = seeds[i];
  return bucket_scan::launch<ExpansionTest,
                             bucket_scan::ScorePick<ChunkHash>>(
      xyz, nullptr, centers, 0u, idx, count, partial, batch, n, m_total,
      k_total, bucket, tile, range, INT_MAX,
      bucket_scan::Params{{r2, 0.f, 0.f, 0.f}}, stream,
      (bucket + 31) / 32 * 32, rows);
}

// The most seeds (center chunks) one launch takes.  It launches nothing.
extern "C" int regnet_group_regions_chunked_max_chunks() {
  return bucket_scan::kMaxChunks;
}

extern "C" int regnet_group_regions_chunked_per_warp() {
  return ExpansionTest::kPerWarp;
}
extern "C" int regnet_group_regions_chunked_stage_cols() {
  return bucket_scan::kMaxStageCols;
}

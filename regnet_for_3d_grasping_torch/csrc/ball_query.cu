// K2 — bucketed radius query (SA1).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/ball_query_pallas.py,
//   ball_query_pallas (_bq_kernel, dispatched from ops/ball_query.py:60-65).
// Bound on the H100: arithmetic.  An exact radius test of a (center,
//   point) pair needs dx, its square and one compare (3 operations): the
//   rounded sum of squares is at least dx*dx, so dx*dx >= r2 rules a pair
//   out.  Only a pair inside that slab needs dy, dz, their squares, the two
//   adds and the compare (7 more), and every pair in radius its count and
//   a place in the bucket's first-hit minimum (2 more); the inputs are a few
//   hundred KB and the output M*K indices.  At the SA1 shape (5,120
//   centers x 25,600 points) that is 131 M pairs, at batch 12 1.57 G.
// Design: the center-tiled bucket scan of bucket_scan.cuh (shared with K11
//   and K5) with its radius test made strict (d2 < r2, 8 centers per warp)
//   and the first pick: a block stages a range of buckets once for a tile
//   of 64 centers, where the kernel this replaces had one block per center
//   re-read the whole cloud from L2 in 12-byte-stride loads and pay a
//   ballot, a popc and an ffs per center and 32 points.  A bucket's pick is
//   its smallest in-radius place, one `redux.sync` minimum over the lanes'
//   first hits, taken only in buckets where some lane hit; the count is
//   exact over the partials, then capped at K by the fill, which also gives
//   empty buckets the first non-empty bucket's pick and a center with no
//   hit all zeros (ball_query_pallas.py:181-185).  Distances are
//   diff-squares with explicit round-to-nearest intrinsics in the JAX
//   order, so membership matches the reference.

#include "bucket_scan.cuh"

using StrictRadiusTest = bucket_scan::BallTest<true>;  // d2 < r2

// xyz [B, N, 3], centers [B, M, 3] f32 -> idx [B, M, K] int32 (0 where a
// center has no point in radius), count [B, M] int32, the in-radius
// population capped at K; partial [B, M, ranges] int32 scratch.  Bucket k
// covers point indices [k*L, (k+1)*L); in radius means d2 < r2.  A block
// owns `tile` centers x `range` buckets (ops/bucket_scan.scan_grid).
extern "C" int regnet_ball_query(const float* xyz, const float* centers,
                                 int32_t* idx, int32_t* count,
                                 int32_t* partial, int batch, int n,
                                 int m_total, int k_total, int bucket,
                                 int tile, int range, float r2,
                                 cudaStream_t stream) {
  return bucket_scan::launch<StrictRadiusTest, bucket_scan::FirstPick>(
      xyz, nullptr, centers, 0u, idx, count, partial, batch, n, m_total,
      k_total, bucket, tile, range, k_total,
      bucket_scan::Params{{r2, 0.f, 0.f, 0.f}}, stream);
}

// The scan's constants that ops/bucket_scan.scan_grid needs: centers per
// warp and the most columns a block stages.  They launch nothing.
extern "C" int regnet_ball_query_per_warp() {
  return StrictRadiusTest::kPerWarp;
}
extern "C" int regnet_ball_query_stage_cols() {
  return bucket_scan::kMaxStageCols;
}

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

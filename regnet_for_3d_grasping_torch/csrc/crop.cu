// K5 — gripper closing-region crop.
//
// Replaces: regnet_for_3d_grasping_tpu/ops/crop_pallas.py,
//   closing_region_crop_pallas (_crop_kernel, dispatched from
//   geometry/region.py:399-408).
// Bound on the H100: arithmetic.  An exact box test of a (proposal,
//   point) pair needs the point's offset and the frame's z row (3
//   subtractions, 3 multiplies, 2 adds, an abs and a compare: 10
//   operations); only a pair inside the z slab needs the x row (3
//   multiplies, 2 adds, 2 compares), only one inside both the y row (7
//   more), and an inside pair its hash and its place in the bucket's argmax
//   (10).  102 M pairs at 4,000 proposals x 25,600 points, over inputs of a
//   few hundred KB.
// Design: the center-tiled bucket scan of bucket_scan.cuh (shared with
//   K11) with the box test below, 2 proposals per warp (the frame, the
//   center: 12 floats each in registers; 2 ran faster than 1, 4 or 8).
//   Every pair is tested exactly, the frame's axes one at a time, and a
//   warp skips the axes left once no lane is inside the slabs tested so
//   far: no cheaper pre-test stands in for the transform.  The frame
//   products are rounded in the JAX order with explicit round-to-nearest
//   intrinsics, so the box test matches the reference point for point.

#include <climits>

#include "bucket_scan.cuh"

namespace {

__device__ __forceinline__ float dot3(float a0, float r0, float a1, float r1,
                                      float a2, float r2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, r0), __fmul_rn(a1, r1)),
                   __fmul_rn(a2, r2));
}

struct BoxTest {
  static constexpr int kPerWarp = 2;
  static constexpr int kUnroll = 1, kMinBlocks = 1;
  float f[9];  // row-major F[k][j]; columns are the gripper axes
  float cx, cy, cz;
  __device__ __forceinline__ void load(const float* frames,
                                       const float* centers, size_t row) {
    for (int e = 0; e < 9; ++e) f[e] = frames[row * 9 + e];
    cx = centers[row * 3];
    cy = centers[row * 3 + 1];
    cz = centers[row * 3 + 2];
  }
  // inside: xlo < x < xhi, |y| < yabs, |z| < zabs (p.v[0..3]) in the frame.
  // Called by the whole warp at once.  The thinnest side, z, is tested
  // first, and when no lane passes it the warp skips the rest; y is
  // computed only where z and x pass, which the compiler branches around,
  // so a warp with no such lane skips it too.  Either way every lane's
  // answer is the whole test's.
  __device__ __forceinline__ bool operator()(
      float x, float y, float z, const bucket_scan::Params& p) const {
    const float r0 = __fsub_rn(x, cx);
    const float r1 = __fsub_rn(y, cy);
    const float r2 = __fsub_rn(z, cz);
    const bool in_z = fabsf(dot3(f[2], r0, f[5], r1, f[8], r2)) < p.v[3];
    if (!__any_sync(0xffffffffu, in_z)) return false;
    const float l0 = dot3(f[0], r0, f[3], r1, f[6], r2);
    return in_z && l0 > p.v[0] && l0 < p.v[1] &&
           fabsf(dot3(f[1], r0, f[4], r1, f[7], r2)) < p.v[2];
  }
};

}  // namespace

// xyz [B, N, 3], frames [B, M, 3, 3], centers [B, M, 3] f32, u32 seed ->
// idx [B, M, K] int32 (0 where a row has no inside point), count [B, M]
// int32 exact inside count; partial [B, M, ranges] int32 scratch.  Box:
// xlo < x < xhi, |y| < yabs, |z| < zabs.  A block owns `tile` proposals x
// `range` buckets (ops/bucket_scan.scan_grid).
extern "C" int regnet_crop(const float* xyz, const float* frames,
                           const float* centers, uint32_t seed, int32_t* idx,
                           int32_t* count, int32_t* partial, int batch, int n,
                           int m_total, int k_total, int bucket, int tile,
                           int range, float xlo, float xhi, float yabs,
                           float zabs, cudaStream_t stream) {
  return bucket_scan::launch<BoxTest, bucket_scan::HashPick>(
      xyz, frames, centers, seed, idx, count, partial, batch, n, m_total,
      k_total, bucket, tile, range, INT_MAX,
      bucket_scan::Params{{xlo, xhi, yabs, zabs}}, stream);
}

// The scan's constants that ops/bucket_scan.scan_grid needs: proposals per
// warp and the most columns a block stages.  They launch nothing.
extern "C" int regnet_crop_per_warp() { return BoxTest::kPerWarp; }
extern "C" int regnet_crop_stage_cols() { return bucket_scan::kMaxStageCols; }

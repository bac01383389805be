// K12 — the served radius grouping of the proposal regions (full scan): the
// JAX package's own function, on a cell grid over each cloud.
//
// Replaces: regnet_for_3d_grasping_tpu/geometry/region.py:160-185, the
//   chunked XLA path of group_regions that the JAX package runs on every
//   backend (its Pallas grouping is off, region.py:302-312).
// Computes, for center m of cloud b: the columns n whose expansion-form
//   d2 = (|c|^2 - 2 c.p) + |p|^2 is at most r2 (ops/distances.bpdist2, the
//   JAX CPU order: cross = fma(cz, pz, fma(cy, py, cx*px)), the norms
//   (x*x + y*y) + z*z), their exact count, and in each bucket of L =
//   ceil(N / K) columns the one with the largest hash_uniform score (the
//   lowbias32 mix of the chunk's [B, chunk, N] linear index and the chunk's
//   seed, one seed a chunk of `chunk` centers, compared as the f32 it
//   rounds to, the first column on a tie); empty buckets take the first
//   non-empty bucket's pick, a center with none index 0 and count 0
//   (ops/sampling.bucket_choice).
// Bound on the H100: bytes.  The function reads the cloud and the centers
//   and writes B*M*K indices and B*M counts, 4.4 MB at serving (4,000
//   centers, K = 256): 0.0013 ms.  The bucket scan this replaces tested
//   every (center, point) pair, 102.4 M at serving, since the expansion
//   form rounds unlike the difference form and no slab of dx rules a pair
//   out; but the radius is 8 mm and about 16 points of a center pass.
// Design: two passes, ops/group.route picks one per call.
//   The grid pass, two launches:
//   1. grid_build_kernel, a cluster of R = kCluster blocks a cloud (an
//      H100 holds 7 such clusters at once; more clouds take turns; each
//      block a slice of the points, kPerThread points a thread loaded at
//      once and kept in registers): the slices' extent, largest point norm P and finite
//      points, merged with `redux.sync` and through rank 0's shared
//      memory; every block then derives the same grid (`make_grid`): cells
//      of side h at least the reach of a center of norm P (below), widened
//      by 1.25 until the grid has at most kMaxCells cells, so that a
//      center near the cloud visits 2-3 cells an axis whatever the extent
//      (one cell where the cloud is smaller than h).  A counting sort in
//      `starts`: each point adds one to its cell's count with a global
//      atomic (in L2) and keeps the count it found as its rank; block r
//      scans the r-th 1/R of the counts into each cell's first record
//      after the blocks before it, and each point writes its record (x, y,
//      z, column) at its cell's first plus its rank.  The order inside a
//      cell follows the atomics, and nothing downstream depends on it.
//      Non-finite points get no record: no center passes them (d2 is NaN
//      or +inf).  No library sort.  (Counting in rank 0's shared memory
//      through the cluster took 0.06 ms at serving on the H100: the other
//      blocks' remote atomics and reads queued at one SM.)
//   2. grid_query_kernel, a warp per center, launched as the build starts
//      (programmatic dependent launch: it clears its keys and loads its
//      center, then waits for the build to end): its visit box
//      (`visit_box`), whose cells in one x row are one run of records, so
//      a lane per row reads the run's ends, a warp scan lays the runs end
//      to end, and the lanes test the records 32 kQueryLoads at a time
//      with the expansion test above.  A record in radius counts, and
//      keeps in shared memory, for its bucket (column / L), the maximum of
//      a 64-bit key: the score's f32 bits plus one above the complemented
//      column (shared 64-bit atomicMax; the maximum does not depend on the
//      order of the updates, so the result is deterministic).  Then the
//      warp writes the K slots and the count.  At most kMaxChunks seeds a
//      launch go by value, so a call copies nothing to the card; more
//      chunks take more launches of the query after the one build.
//   The direct pass, one launch (direct_kernel), for calls of few pairs
//   (a training batch, 12 x 64 centers, or a validation forward), where
//   the build's fixed cost exceeds what its pruning saves: a block holds C
//   centers and their keys and streams the whole cloud; the same test and
//   keys, no grid and no scratch.
//
// Why no pair in radius is missed.  Let u = 2^-24, A = |c| and P the
//   cloud's largest point norm.  |c|^2 and |p|^2, rounded sums of rounded
//   squares, lie within gamma3 = 3u / (1 - 3u) of A^2 and |p|^2 relative,
//   and the cross term (a product, two fused multiply-adds) within gamma3
//   sum |c_i p_i| <= gamma3 A P of c.p, so the sum of the rounded pieces
//   S = |c|^2 - 2 cross + |p|^2 lies within gamma3 (A + P)^2 of D =
//   |c - p|^2.  fma(-2, cross, |c|^2) rounds once, by at most
//   u (|c|^2 + 2 |cross|) <= u (1 + gamma3) (A + P)^2, and the last add by
//   a factor 1 + delta, |delta| <= u.  So d2 <= r2 gives D <= r2 / (1 - u)
//   + (gamma3 + u (1 + gamma3)) (A + P)^2 < r2 (1 + 2u) + 5u (A + P)^2;
//   underflow adds at most 2^-150 a step.  A step that overflows gives
//   +inf or NaN, which fails, or -inf only where S < 0 or the cross term
//   passed FLT_MAX, and then D is within gamma3 (A + P)^2 too.  `reach`
//   takes rho^2 = r2 (1 + 4u) + 8u (A + P)^2 + 2^-120 in double (whose own
//   rounding, 2^-53 relative, the doubled terms cover) and rounds rho up to
//   f32, so a point that passes lies in [c_i - rho, c_i + rho] on each
//   axis.  `visit_box` rounds those ends outward (to nearest, then one
//   step away), and the cell of a coordinate, `cell_axis`, clamp(floor((x
//   - lo) * inv_h), 0, G - 1) in f32, never decreases as x grows (each
//   rounded step is monotone); the build and the query share that
//   function, so a passing point's cell on each axis lies between the
//   cells of the two ends, which the query visits.  No margin is needed
//   for the cell arithmetic; h, lo and G only set how many cells a center
//   visits.  A box that misses the cloud's extent on an axis holds no
//   point and is skipped; a center with a non-finite coordinate has
//   |c|^2 = +inf or NaN, so every d2 is +inf or NaN and none passes.
//   ops/group.py computes the same grid and boxes (`grid_plan`,
//   `grid_visits`) for the tests and chip_smoke.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCells = 32768;  // cells of a grid
constexpr int kBuildThreads = 1024;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kPerThread = 2;   // points a build thread loads at once
constexpr int kCluster = 16;     // blocks a cloud in the build
constexpr int kQueryWarps = 8;    // centers a query block
constexpr int kMaxChunks = 64;    // seeds a query launch takes by value
constexpr int kQueryLoads = 4;    // records a query lane loads at once
constexpr int kDirectThreads = 1024;  // a direct pass block
// shared memory a direct pass block may use for its centers' bucket keys
constexpr size_t kMaxDirectSmem = 200 * 1024;
constexpr int kGridWords = 16;
// shared memory a query block may use for its warps' bucket keys
constexpr size_t kMaxQuerySmem = 200 * 1024;

// A cloud's grid (ops/group.grid_views reads it as kGridWords words).
struct Grid {
  float lo[3];     // the least finite coordinate on each axis
  float inv_h;     // 1 / the cell side, rounded to f32
  int dims[3];     // cells on each axis, their product <= kMaxCells
  int points;      // finite points: the records
  double p_norm;   // the largest finite point norm
  float hi[3];     // the largest finite coordinate on each axis
  int pad[3];
};
static_assert(sizeof(Grid) == kGridWords * 4, "Grid is kGridWords words");
static_assert(kMaxCells % kCluster == 0, "the blocks share the cells evenly");

// A slice's extent as order-preserving keys of the floats (`ordered`),
// the bits of its largest squared norm (a double, >= 0: its bits order as
// its values) and its finite points; merged with `redux.sync`.
struct Part {
  uint32_t lo[3], hi[3];
  unsigned long long p2;
  uint32_t points;
};

__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float unordered(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7FFFFFFFu : ~k);
}

// the part of no point
__device__ __forceinline__ Part no_part() {
  return Part{{0xFF800000u, 0xFF800000u, 0xFF800000u},   // +inf
              {0x007FFFFFu, 0x007FFFFFu, 0x007FFFFFu},   // -inf
              0ull, 0u};
}

struct Seeds {
  uint32_t v[kMaxChunks];
};

// The half-width of the box a center of norm `a` must visit in a cloud of
// largest norm `p` (the argument above); ops/group.reach computes the same.
__device__ __forceinline__ float reach(double a, double p, float r2) {
  const double s = a + p;
  const double rho2 =
      (double)r2 * (1.0 + 0x1p-22) + 0x1p-21 * (s * s) + 0x1p-120;
  return nextafterf(__double2float_rn(sqrt(rho2)), INFINITY);
}

// The cell of coordinate x on one axis: monotone in x (see above).
__device__ __forceinline__ int cell_axis(float x, float lo, float inv_h,
                                         int dims) {
  const float f = floorf(__fmul_rn(__fsub_rn(x, lo), inv_h));
  return (int)fminf(fmaxf(f, 0.f), (float)(dims - 1));
}

__device__ __forceinline__ int cell_of(const Grid& g, float x, float y,
                                       float z) {
  return (cell_axis(z, g.lo[2], g.inv_h, g.dims[2]) * g.dims[1] +
          cell_axis(y, g.lo[1], g.inv_h, g.dims[1])) *
             g.dims[0] +
         cell_axis(x, g.lo[0], g.inv_h, g.dims[0]);
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__device__ __forceinline__ void add_point(Part& a, float x, float y,
                                          float z) {
  const uint32_t k[3] = {ordered(x), ordered(y), ordered(z)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a.lo[i] = min(a.lo[i], k[i]);
    a.hi[i] = max(a.hi[i], k[i]);
  }
  const double dx = x, dy = y, dz = z;
  const unsigned long long p2 =
      __double_as_longlong((dx * dx + dy * dy) + dz * dz);
  a.p2 = p2 > a.p2 ? p2 : a.p2;
  ++a.points;
}

// The parts of a warp's lanes merged, on every lane.
__device__ __forceinline__ Part warp_merge(Part p) {
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.lo[i] = __reduce_min_sync(kAll, p.lo[i]);
    p.hi[i] = __reduce_max_sync(kAll, p.hi[i]);
  }
  const uint32_t top = __reduce_max_sync(kAll, (uint32_t)(p.p2 >> 32));
  const uint32_t low = __reduce_max_sync(
      kAll, (uint32_t)(p.p2 >> 32) == top ? (uint32_t)p.p2 : 0u);
  p.p2 = ((unsigned long long)top << 32) | low;
  p.points = __reduce_add_sync(kAll, p.points);
  return p;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// The grid of a cloud from its merged parts, called by a whole warp
// (ops/group.grid_plan: the same double arithmetic, so the same grid).
// Lane j tries h widened j times by 1.25, the steps of a sequential
// search, and the first lane whose grid fits wins.
__device__ Grid make_grid(const Part& all, float r2, int lane) {
  Grid g{};
  g.points = (int)all.points;
  g.inv_h = 1.f;
  g.dims[0] = g.dims[1] = g.dims[2] = 1;
  if (all.points == 0) return g;
  g.p_norm = sqrt(__longlong_as_double(all.p2));
  double ext[3], widest = 0.0;
  for (int i = 0; i < 3; ++i) {
    g.lo[i] = unordered(all.lo[i]);
    g.hi[i] = unordered(all.hi[i]);
    ext[i] = (double)g.hi[i] - (double)g.lo[i];
    widest = fmax(widest, ext[i]);
  }
  double first = fmax((double)reach(g.p_norm, g.p_norm, r2),
                      widest / kMaxCells);
  for (;;) {
    double h = first;
    for (int t = 0; t < lane; ++t) h *= 1.25;
    double d[3];
    for (int i = 0; i < 3; ++i) d[i] = floor(ext[i] / h) + 1.0;
    const unsigned fits =
        __ballot_sync(0xffffffffu, d[0] * d[1] * d[2] <= kMaxCells);
    if (fits) {
      const int j = __ffs(fits) - 1;
      g.inv_h = __double2float_rn(1.0 / __shfl_sync(0xffffffffu, h, j));
      for (int i = 0; i < 3; ++i)
        g.dims[i] = (int)__shfl_sync(0xffffffffu, d[i], j);
      return g;
    }
    first = __shfl_sync(0xffffffffu, h, 31) * 1.25;
  }
}

// The exclusive scan of in[0, n) into s[0, n), one block of
// kBuildThreads; returns the total.  Loaded coalesced, each thread scans an
// odd run of entries (odd: the runs' strided reads meet no bank twice),
// the runs' sums scanned across the block.  `in` holds counts that other
// blocks' atomics wrote in L2 during this launch: read there (`__ldcg`),
// never through L1 or the read-only path.
__device__ int scan_range(const int32_t* in, int n, int* s, int* s_wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += kBuildThreads) s[j] = __ldcg(in + j);
  __syncthreads();
  const int run = ((n + kBuildThreads - 1) / kBuildThreads) | 1;
  const int lo = min(n, (int)threadIdx.x * run), hi = min(n, lo + run);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += s[j];
  const int incl = warp_inclusive(sum, lane);
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = s_wsum[lane];
    const int w = warp_inclusive(v, lane);
    s_wsum[lane] = w - v;
    if (lane == 31) s_wsum[kBuildWarps] = w;
  }
  __syncthreads();
  int at = s_wsum[warp] + incl - sum;
  for (int j = lo; j < hi; ++j) {
    const int v = s[j];
    s[j] = at;
    at += v;
  }
  __syncthreads();
  return s_wsum[kBuildWarps];
}

// The points [i, i + kPerThread * kBuildThreads) of a slice that ends at
// i1, kPerThread a thread, loaded at once: x[k] of point i + k *
// kBuildThreads + threadIdx.x; `ok[k]`: the point exists and is finite.
struct Batch {
  float x[kPerThread], y[kPerThread], z[kPerThread];
  int i[kPerThread];
  bool ok[kPerThread];
  __device__ __forceinline__ Batch(const float* __restrict__ cloud, int base,
                                   int i1) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      i[k] = base + k * kBuildThreads + (int)threadIdx.x;
      const bool in = i[k] < i1;
      x[k] = in ? cloud[3 * i[k]] : 0.f;
      y[k] = in ? cloud[3 * i[k] + 1] : 0.f;
      z[k] = in ? cloud[3 * i[k] + 2] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      ok[k] = i[k] < i1 && finite3(x[k], y[k], z[k]);
  }
};

// xyz [B, N, 3] -> grids [B], starts [B, kMaxCells + 1] (cell c's records
// are [starts[c], starts[c + 1])), records [B, N] (x, y, z, column bits),
// ranks [B, N] scratch.  A cluster of kCluster blocks a cloud, each a slice
// of its points (the first kPerThread a thread kept in registers from the
// first phase to the last); the cells' counts, then their first records,
// in `starts`; each block scans a 1/kCluster of the cells.
__global__ void __launch_bounds__(kBuildThreads, 1)
grid_build_kernel(const float* __restrict__ xyz, int n, float r2,
                  Grid* __restrict__ grids, int32_t* __restrict__ starts,
                  float4* __restrict__ records, int32_t* __restrict__ ranks) {
  __shared__ int s_scan[kMaxCells / kCluster];  // this block's cells' prefix
  __shared__ Part s_part[kCluster];      // rank 0's: each block's part
  __shared__ int s_total[kCluster];      // rank 0's: each block's cells
  __shared__ Part s_warp[kBuildWarps];
  __shared__ int s_wsum[kBuildWarps + 1];
  __shared__ Grid s_grid;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int size = kCluster;
  const int b = blockIdx.x / size;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* cloud = xyz + (size_t)b * n * 3;
  const int per = (n + size - 1) / size;
  const int i0 = min(n, rank * per), i1 = min(n, i0 + per);
  constexpr int kStep = kPerThread * kBuildThreads;
  int32_t* cnt = starts + (size_t)b * (kMaxCells + 1);
  int32_t* rk = ranks + (size_t)b * n;
  // the query may start: it waits for this grid to end before it reads
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // 1. this block's extent, largest norm and finite points; the blocks
  // zero the counts meanwhile
  const Batch first(cloud, i0, i1);
  Part me = no_part();
  auto add = [&](const Batch& p) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (p.ok[k]) add_point(me, p.x[k], p.y[k], p.z[k]);
  };
  add(first);
  for (int base = i0 + kStep; base < i1; base += kStep)
    add(Batch(cloud, base, i1));
  for (int j = rank * kBuildThreads + threadIdx.x; j < kMaxCells;
       j += size * kBuildThreads)
    cnt[j] = 0;
  me = warp_merge(me);
  if (lane == 0) s_warp[warp] = me;
  __syncthreads();
  if (warp == 0) {
    me = warp_merge(s_warp[lane]);
    if (lane == 0) cluster.map_shared_rank(s_part, 0)[rank] = me;
  }
  cluster.sync();

  // 2. the grid, derived alike by every block from the parts
  if (warp == 0) {
    const Part all = warp_merge(
        lane < size ? cluster.map_shared_rank(s_part, 0)[lane] : no_part());
    const Grid g = make_grid(all, r2, lane);
    if (lane == 0) s_grid = g;
  }
  __syncthreads();
  const Grid& g = s_grid;

  // 3. each cell's count; a point's rank is the count it found
  int cell0[kPerThread];
  auto count = [&](const Batch& p, int (&cell)[kPerThread]) {
    int got[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      cell[k] = p.ok[k] ? cell_of(g, p.x[k], p.y[k], p.z[k]) : 0;
      if (p.ok[k]) got[k] = atomicAdd(&cnt[cell[k]], 1);
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (p.ok[k]) rk[p.i[k]] = got[k];
  };
  count(first, cell0);
  for (int base = i0 + kStep; base < i1; base += kStep) {
    int cell[kPerThread];
    count(Batch(cloud, base, i1), cell);
  }
  cluster.sync();

  // 4. each cell's first record: block r scans the r-th 1/R of the cells,
  // then adds the counts of the blocks before it
  const int cells = g.dims[0] * g.dims[1] * g.dims[2];
  const int span = (cells + size - 1) / size;
  const int c0 = min(cells, rank * span), c1 = min(cells, c0 + span);
  const int mine = scan_range(cnt + c0, c1 - c0, s_scan, s_wsum);
  if (threadIdx.x == 0) cluster.map_shared_rank(s_total, 0)[rank] = mine;
  cluster.sync();
  const int t = lane < size ? cluster.map_shared_rank(s_total, 0)[lane] : 0;
  const int before = (int)__reduce_add_sync(0xffffffffu, lane < rank ? t : 0);
  for (int j = threadIdx.x; j < c1 - c0; j += kBuildThreads)
    cnt[c0 + j] = before + s_scan[j];
  if (rank == 0 && threadIdx.x == 0)
    cnt[cells] = g.points;
  cluster.sync();

  // 5. each point's record at its cell's first plus its rank
  auto place = [&](const Batch& p, const int (&cell)[kPerThread]) {
    int pos[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (p.ok[k]) pos[k] = cnt[cell[k]] + rk[p.i[k]];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (p.ok[k])
        records[(size_t)b * n + pos[k]] =
            make_float4(p.x[k], p.y[k], p.z[k], __int_as_float(p.i[k]));
  };
  place(first, cell0);
  for (int base = i0 + kStep; base < i1; base += kStep) {
    const Batch p(cloud, base, i1);
    int cell[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      cell[k] = p.ok[k] ? cell_of(g, p.x[k], p.y[k], p.z[k]) : 0;
    place(p, cell);
  }
  if (rank == 0 && threadIdx.x == 0) grids[b] = g;
}

// The cells a center visits on each axis, [box[2i], box[2i + 1]]; false
// where it visits none (see above).  ops/group.grid_visits is the same.
__device__ __forceinline__ bool visit_box(const Grid& g, float cx, float cy,
                                          float cz, float r2, int (&box)[6]) {
  if (g.points == 0 || !finite3(cx, cy, cz)) return false;
  const double x = cx, y = cy, z = cz;
  const float rho = reach(sqrt((x * x + y * y) + z * z), g.p_norm, r2);
  const float c[3] = {cx, cy, cz};
  bool any = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = nextafterf(__fsub_rn(c[i], rho), -INFINITY);
    const float hi = nextafterf(__fadd_rn(c[i], rho), INFINITY);
    any = any && !(hi < g.lo[i] || lo > g.hi[i]);
    box[2 * i] = cell_axis(lo, g.lo[i], g.inv_h, g.dims[i]);
    box[2 * i + 1] = cell_axis(hi, g.lo[i], g.inv_h, g.dims[i]);
  }
  return any;
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// The expansion test of point p (|p|^2 = p2) against center c (|c|^2 =
// c2).
__device__ __forceinline__ bool in_radius(float cx, float cy, float cz,
                                          float c2, float x, float y, float z,
                                          float p2, float r2) {
  const float cross = __fmaf_rn(cz, z, __fmaf_rn(cy, y, __fmul_rn(cx, x)));
  return __fadd_rn(__fmaf_rn(-2.f, cross, c2), p2) <= r2;
}

// ops/sampling.hash_uniform over the chunk's [B, chunk, N] linear index:
// the part of center m of cloud b (its chunk's `seed`), then a column's key:
// the score's f32 bits plus one above the complemented column.
__device__ __forceinline__ uint32_t hash_row(int b, int m, int chunk, int n,
                                             uint32_t seed) {
  const uint32_t lin =
      ((uint32_t)b * (uint32_t)chunk + (uint32_t)(m % chunk)) * (uint32_t)n;
  return lin * 2654435761u + seed * 0x9E3779B9u;
}

__device__ __forceinline__ unsigned long long pick_key(uint32_t row,
                                                       uint32_t col) {
  uint32_t x = row + col * 2654435761u;
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 16;
  x *= 0x45D9F3Bu;
  x ^= x >> 16;
  const uint32_t score = __float_as_uint(__uint2float_rn(x));
  return ((unsigned long long)(score + 1u) << 32) | (0xFFFFFFFFu - col);
}

__device__ __forceinline__ int key_column(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

// centers [B, M, 3] -> idx [B, M, K], count [B, M] for centers [m0, m0 +
// mcount) of each cloud, whose chunks start at chunk `chunk0` (seeds[0]).
__global__ void __launch_bounds__(kQueryWarps * 32)
grid_query_kernel(const float* __restrict__ centers,
                  const Grid* __restrict__ grids,
                  const int32_t* __restrict__ starts,
                  const float4* __restrict__ records, Seeds seeds, int chunk,
                  int chunk0, int m0, int mcount, int32_t* __restrict__ idx,
                  int32_t* __restrict__ count, int batch, int n, int m_total,
                  int k_total, int bucket, float r2) {
  extern __shared__ unsigned long long s_keys[];  // [warps][K]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= (long long)batch * mcount) return;
  const int b = (int)(w / mcount), m = m0 + (int)(w % mcount);
  unsigned long long* keys = s_keys + (size_t)warp * k_total;
  for (int k = lane; k < k_total; k += 32) keys[k] = 0ull;
  const size_t row = (size_t)b * m_total + m;
  const float cx = centers[row * 3], cy = centers[row * 3 + 1],
              cz = centers[row * 3 + 2];
  // what the build wrote is read only once it has ended
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const Grid g = grids[b];
  int hits = 0;
  int box[6];
  __syncwarp();
  if (visit_box(g, cx, cy, cz, r2, box)) {
    const float c2 = norm2(cx, cy, cz);
    const uint32_t hrow =
        hash_row(b, m, chunk, n, seeds.v[m / chunk - chunk0]);
    const int32_t* st = starts + (size_t)b * (kMaxCells + 1);
    const float4* rec = records + (size_t)b * n;
    const int ny = box[3] - box[2] + 1;
    const int rows = ny * (box[5] - box[4] + 1);
    for (int r0 = 0; r0 < rows; r0 += 32) {
      // lane r: the run of row r0 + r, cells box[0]..box[1]
      const int r = r0 + lane;
      int s = 0, len = 0;
      if (r < rows) {
        const int first =
            ((box[4] + r / ny) * g.dims[1] + box[2] + r % ny) * g.dims[0];
        s = st[first + box[0]];
        len = st[first + box[1] + 1] - s;
      }
      const int incl = warp_inclusive(len, lane);
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      // 32 kQueryLoads candidates a round, a lane's loads in flight together
      for (int j0 = 0; j0 < total; j0 += 32 * kQueryLoads) {
        int from[kQueryLoads];
#pragma unroll
        for (int u = 0; u < kQueryLoads; ++u) {
          // the run of candidate j: the lanes whose runs end at or before j
          const int j = j0 + 32 * u + lane;
          int src = 0;
          for (int step = 16; step; step >>= 1)
            if (__shfl_sync(0xffffffffu, incl, src + step - 1) <= j)
              src += step;
          from[u] = __shfl_sync(0xffffffffu, s, src) + j -
                    (__shfl_sync(0xffffffffu, incl, src) -
                     __shfl_sync(0xffffffffu, len, src));
        }
        float4 p[kQueryLoads];
#pragma unroll
        for (int u = 0; u < kQueryLoads; ++u)
          if (j0 + 32 * u + lane < total) p[u] = rec[from[u]];
#pragma unroll
        for (int u = 0; u < kQueryLoads; ++u) {
          if (j0 + 32 * u + lane >= total ||
              !in_radius(cx, cy, cz, c2, p[u].x, p[u].y, p[u].z,
                         norm2(p[u].x, p[u].y, p[u].z), r2))
            continue;
          ++hits;
          const uint32_t col = __float_as_uint(p[u].w);
          atomicMax(&keys[col / (uint32_t)bucket], pick_key(hrow, col));
        }
      }
    }
  }
  __syncwarp();
  hits = __reduce_add_sync(0xffffffffu, hits);
  // the first non-empty bucket's pick fills the empty ones (0 if none)
  int fill = 0;
  for (int k0 = 0; k0 < k_total; k0 += 32) {
    const int k = k0 + lane;
    const unsigned long long v = k < k_total ? keys[k] : 0ull;
    const unsigned has = __ballot_sync(0xffffffffu, v != 0ull);
    if (has) {
      fill = __shfl_sync(0xffffffffu, key_column(v), __ffs(has) - 1);
      break;
    }
  }
  int32_t* out = idx + row * k_total;
  for (int k = lane; k < k_total; k += 32) {
    const unsigned long long v = keys[k];
    out[k] = v ? key_column(v) : fill;
  }
  if (lane == 0) count[row] = hits;
}

// The direct pass, for calls of few pairs, where the grid's build would
// cost more than the pairs it saves: block (m, b) holds C centers of cloud
// b (in every thread's registers: all C tested against each point it
// loads) and their buckets' keys in shared memory, streams the whole cloud
// (kBatch points a thread in flight) and writes the C centers' rows and
// counts itself: one launch, no scratch.
template <int C>
__global__ void __launch_bounds__(kDirectThreads)
direct_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
              Seeds seeds, int chunk, int32_t* __restrict__ idx,
              int32_t* __restrict__ count, int n, int m_total, int k_total,
              int bucket, float r2) {
  constexpr int kBatch = 8;
  extern __shared__ unsigned long long s_keys[];  // [C][K]
  __shared__ int s_hits[C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, m0 = blockIdx.x * C;
  float cx[C], cy[C], cz[C], c2[C];
  uint32_t row[C];
  int hits[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int m = min(m0 + i, m_total - 1);
    const float* cp = centers + ((size_t)b * m_total + m) * 3;
    cx[i] = cp[0];
    cy[i] = cp[1];
    cz[i] = cp[2];
    // a center past the last passes no test (|c|^2 NaN)
    c2[i] = m0 + i < m_total ? norm2(cx[i], cy[i], cz[i])
                             : __int_as_float(0x7fc00000);
    row[i] = hash_row(b, m, chunk, n, seeds.v[m / chunk]);
    hits[i] = 0;
  }
  for (int k = threadIdx.x; k < C * k_total; k += kDirectThreads)
    s_keys[k] = 0ull;
  if (threadIdx.x < C) s_hits[threadIdx.x] = 0;
  __syncthreads();
  const float* cloud = xyz + (size_t)b * n * 3;
  for (int base = 0; base < n; base += kBatch * kDirectThreads) {
    float px[kBatch], py[kBatch], pz[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = min(base + u * kDirectThreads + (int)threadIdx.x, n - 1);
      px[u] = cloud[3 * j];
      py[u] = cloud[3 * j + 1];
      pz[u] = cloud[3 * j + 2];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * kDirectThreads + (int)threadIdx.x;
      if (j >= n) break;
      const float p2 = norm2(px[u], py[u], pz[u]);
      // the tests without a branch; the rare passes after
      uint32_t pass = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const bool in = in_radius(cx[i], cy[i], cz[i], c2[i], px[u], py[u],
                                  pz[u], p2, r2);
        hits[i] += in;
        pass |= (uint32_t)in << i;
      }
      if (!pass) continue;
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (pass >> i & 1u)
          atomicMax(&s_keys[i * k_total + j / bucket],
                    pick_key(row[i], (uint32_t)j));
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int total = __reduce_add_sync(0xffffffffu, hits[i]);
    if (lane == 0 && total) atomicAdd(&s_hits[i], total);
  }
  __syncthreads();
  // warp w writes center i = w, w + warps, ...: its empty buckets take the
  // first non-empty bucket's pick (0 if none)
  for (int i = warp; i < C && m0 + i < m_total; i += kDirectThreads / 32) {
    const unsigned long long* keys = s_keys + i * k_total;
    int fill = 0;
    for (int k0 = 0; k0 < k_total; k0 += 32) {
      const int k = k0 + lane;
      const unsigned long long v = k < k_total ? keys[k] : 0ull;
      const unsigned has = __ballot_sync(0xffffffffu, v != 0ull);
      if (has) {
        fill = __shfl_sync(0xffffffffu, key_column(v), __ffs(has) - 1);
        break;
      }
    }
    const size_t r = (size_t)b * m_total + m0 + i;
    for (int k = lane; k < k_total; k += 32)
      idx[r * k_total + k] = keys[k] ? key_column(keys[k]) : fill;
    if (lane == 0) count[r] = s_hits[i];
  }
}

template <int C>
int launch_direct(const float* xyz, const float* centers, const Seeds& s,
                  int chunk, int32_t* idx, int32_t* count, int batch, int n,
                  int m_total, int k_total, int bucket, float r2,
                  cudaStream_t stream) {
  const size_t smem = (size_t)C * k_total * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      direct_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  direct_kernel<C><<<dim3((m_total + C - 1) / C, batch), kDirectThreads,
                     smem, stream>>>(xyz, centers, s, chunk, idx, count, n,
                                     m_total, k_total, bucket, r2);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz [B, N, 3], centers [B, M, 3] f32, seeds [chunks] u32 on the host (one
// per `chunk` centers) -> idx [B, M, K] int32 (0 where a center has no
// point in radius), count [B, M] int32, exact.  Bucket k covers columns
// [k*L, (k+1)*L), L = `bucket`; in radius means the expansion-form d2 <=
// r2.  `per_block` == 0: the grid pass, with the scratch of
// ops/group.grid_views: records [B, N] float4, starts [B, kMaxCells + 1],
// ranks [B, N] int32, grids [B] (kGridWords words each); its query spreads
// few centers over the card's `sms` SMs.  `per_block` 1 or 4: the direct
// pass, that many centers a block, at most kMaxChunks chunks; it reads no
// scratch.  B*chunk*N must stay below 2^32 (the hash's u32 counter).
extern "C" int regnet_group_regions_chunked(
    const float* xyz, const float* centers, const uint32_t* seeds, int chunk,
    int chunks, int32_t* idx, int32_t* count, float* records,
    int32_t* starts, int32_t* ranks, void* grids, int batch, int n,
    int m_total, int k_total, int bucket, int per_block, int sms, float r2,
    cudaStream_t stream) {
  if (batch < 1 || n < 1 || m_total < 1 || k_total < 1 || bucket < 1 ||
      (long long)k_total * bucket < n || chunk < 1 ||
      chunks != (m_total + chunk - 1) / chunk || sms < 1 || !(r2 >= 0.f) ||
      !(r2 < INFINITY))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  if (per_block != 0) {
    if (chunks > kMaxChunks ||
        (size_t)per_block * k_total * sizeof(unsigned long long) >
            kMaxDirectSmem)
      return (int)cudaErrorInvalidValue;
    Seeds s{};
    for (int i = 0; i < chunks; ++i) s.v[i] = seeds[i];
    switch (per_block) {
      case 1: return launch_direct<1>(xyz, centers, s, chunk, idx, count,
                                      batch, n, m_total, k_total, bucket, r2,
                                      stream);
      case 4: return launch_direct<4>(xyz, centers, s, chunk, idx, count,
                                      batch, n, m_total, k_total, bucket, r2,
                                      stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const size_t keys = (size_t)k_total * sizeof(unsigned long long);
  if (keys > kMaxQuerySmem) return (int)cudaErrorInvalidValue;
  // clusters of more than 8 blocks are not portable: allowed here
  cudaError_t err = cudaFuncSetAttribute(
      grid_build_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kBuildThreads);
  cfg.stream = stream;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = kCluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  Grid* g = static_cast<Grid*>(grids);
  float4* rec = reinterpret_cast<float4*>(records);
  err = cudaLaunchKernelEx(&cfg, grid_build_kernel, xyz, n, r2, g, starts,
                           rec, ranks);
  if (err != cudaSuccess) return (int)err;

  // warps (centers) a query block: fewer where the centers are few, so
  // that they spread over the SMs
  const long long centers_total = (long long)batch * m_total;
  const int warps = (int)std::max<long long>(
      1, std::min<long long>({(long long)kQueryWarps,
                              (long long)(kMaxQuerySmem / keys),
                              centers_total / sms}));
  err = cudaFuncSetAttribute(grid_query_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(warps * keys));
  if (err != cudaSuccess) return (int)err;
  // each query launch may start before the launch before it ends (the
  // build lets it), and waits for it before it reads the build's output
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = warps * keys;
  cfg.attrs = attr;
  for (int k0 = 0; k0 < chunks; k0 += kMaxChunks) {
    const int nk = std::min(kMaxChunks, chunks - k0);
    Seeds s{};
    for (int i = 0; i < nk; ++i) s.v[i] = seeds[k0 + i];
    const int m0 = k0 * chunk;
    const int mcount = std::min(m_total, (k0 + nk) * chunk) - m0;
    cfg.gridDim =
        dim3((unsigned)(((long long)batch * mcount + warps - 1) / warps));
    err = cudaLaunchKernelEx(&cfg, grid_query_kernel, centers, g, starts,
                             rec, s, chunk, k0, m0, mcount, idx, count, batch,
                             n, m_total, k_total, bucket, r2);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// K1 — masked iterative farthest point sampling, and K10 — its grouped
// (stratified) form, both on one kernel (fps_cluster_kernel).
//
// Replaces: regnet_for_3d_grasping_tpu/ops/fps_pallas.py, fps_pallas
//   (_fps_kernel_v2, fps_pallas.py:260, dispatched from ops/fps.py:134) and
//   fps_pallas_grouped (_fps_kernel_grouped, fps_pallas.py:211, dispatched
//   from ops/fps.py:119).
// Bound on the H100: latency.  The S steps depend on each other and each
//   does about 10 flops per point, so the bytes and operations bound
//   (0.02 ms at 25,600 -> 5,120) says little: the floor is S times one
//   step's latency, a distance update plus an argmax across the field
//   whose result every block needs before the next step.
// K1 design (fps_cluster_kernel): each cloud is a thread-block cluster of R
//   blocks (R = 16, 8, 4, 2 or 1, chosen by the wrapper from the batch and
//   N: ops/fps.cluster_size), each owning a contiguous chunk of about N/R
//   points whose coordinates and running distance live in shared memory
//   for the whole
//   loop, so after the first load no step reads the cloud from L2 and the
//   field is spread over R SMs instead of one.  A step is the chunk's
//   distance update (about 4 points per thread), a first-index argmax in
//   the block (two redux.sync per warp on a packed 64-bit key, one
//   __syncthreads, then one warp), a 20-byte record (the key and the
//   candidate's x, y, z) that R lanes store into every block's shared
//   memory with st.async, each store counting its bytes on that block's
//   mbarrier, a wait on the block's own mbarrier, and a local reduction of
//   the R records, after which every block holds the winner and its
//   coordinates.  Waiting for the R records replaces a cluster barrier,
//   which needs every thread of every block to arrive (at 25,600 -> 5,120
//   on the H100, 7.2 ms with a cluster barrier per step, 5.1 ms with the
//   waits); two record buffers, by step parity, make a second wait
//   unnecessary.  Distances are diff-squares summed as
//   ((dx*dx + dy*dy) + dz*dz) with explicit round-to-nearest intrinsics, the
//   JAX order, so every pick is bit-identical to the reference.
// K10 design: G independent exact runs of S/G samples over the G
//   contiguous slices of N/G points.  The TPU kernel advances all slices in
//   one program because a TPU core runs one program at a time; here K10 is
//   K1 itself over the free view [B*G, N/G] of the cloud: each slice is one
//   cluster of R blocks (R chosen by the wrapper for B*G clusters of N/G
//   points), and the kernel's `groups` argument adds the slice's offset
//   (b % G) * N/G to every pick, so the output [B*G, S/G] is the
//   slice-major [B, S] with offsets.  The slices run at once and the
//   dependent steps drop from S to S/G.  A slice is small, so the step is
//   the exchange, which grows with R: the wrapper gives a block at least 512
//   points (ops/fps.MIN_CHUNK), R = 4 at the serving shapes (8 slices of
//   3,200 points; 0.53 ms at 25,600 -> 5,120 against 0.60 at R = 16 on the
//   H100).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kPointsPerThread = 4;  // K1: chunk points per thread, at most

// The K1 argmax key: larger distance first, then the lower global index.
// The float's bits are mapped so that unsigned order is float order (for
// the values the field holds: -1, +0, positive distances, 1e10), and the
// index is complemented so that a lower index is a larger key.  Every key
// of a real point is above 0, so 0 stands for "no candidate".
// ops/fps.py `fps_key` is its twin.
__device__ __forceinline__ unsigned long long fps_key(float v, int i) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~i;
}

// A block's candidate: its key and its coordinates (20 bytes, two stores).
struct __align__(16) Record {
  unsigned long long key;
  float x, y, z;
};
constexpr unsigned kRecordBytes = 20;

// One exchange buffer: a record from every block of the cluster, and the
// mbarrier whose phase completes when all of them have landed.
struct Exchange {
  Record rec[kMaxCluster];
  unsigned long long bar;
};

// The largest key of the warp, in every lane: two 32-bit reductions, the
// high words, then the low words of the lanes that hold the highest.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned remote_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Stores `rec` at `addr` in another block (DSMEM), each store counting its
// bytes on that block's mbarrier `bar`.
__device__ __forceinline__ void send_record(unsigned addr, unsigned bar,
                                            const Record& rec) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"((unsigned)rec.key), "r"((unsigned)(rec.key >> 32)),
         "r"(__float_as_uint(rec.x)), "r"(__float_as_uint(rec.y)), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];"
      :: "r"(addr + 16), "r"(__float_as_uint(rec.z)), "r"(bar) : "memory");
}

// Waits for the phase of parity `parity` of the mbarrier `bar`.  A wait
// never lasts longer than the other blocks' step, so one that spins 2^24
// times is a fault, and traps instead of hanging the card.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins > (1ll << 24)) __trap();
  }
}

// Exchange `e` of the cluster-wide argmax of the per-thread best (bv at
// local index bi, -1 for none) over the chunk `pts` that starts at global
// index `lo`: returns the winner's global index and its coordinates, in
// every thread of the cluster.  Exchange e uses buffer e % 2, in the phase
// e / 2 of its mbarrier; a block sends exchange e + 2's record only after
// it has every record of exchange e + 1, which each block sends after
// reading exchange e, so two buffers suffice and no cluster barrier is
// needed.
__device__ int cluster_argmax(cg::cluster_group& cluster, float bv, int bi,
                              int lo, const float4* pts,
                              unsigned long long* wkey, Exchange* ex, int e,
                              float& cx, float& cy, float& cz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_total = (int)cluster.num_blocks();
  Exchange& x = ex[e & 1];
  unsigned long long k = warp_max(bi >= 0 ? fps_key(bv, lo + bi) : 0ull);
  if (lane == 0) wkey[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = warp_max(lane < (int)(blockDim.x >> 5) ? wkey[lane] : 0ull);
    if (lane < r_total) {  // lane r sends the block's record to block r
      Record rec{k, 0.f, 0.f, 0.f};
      if (k != 0) {
        const float4 p = pts[(int)~(unsigned)k - lo];
        rec.x = p.x;
        rec.y = p.y;
        rec.z = p.z;
      }
      send_record(remote_addr(smem_addr(&x.rec[cluster.block_rank()]), lane),
                  remote_addr(smem_addr(&x.bar), lane), rec);
    }
  }
  if (threadIdx.x == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;"
        :: "r"(smem_addr(&x.bar)), "r"(kRecordBytes * r_total) : "memory");
  wait_phase(smem_addr(&x.bar), (e >> 1) & 1);
  // every warp reduces the R records itself: lane r reads record r
  const unsigned long long mine = lane < r_total ? x.rec[lane].key : 0;
  k = warp_max(mine);
  const Record& win = x.rec[__ffs(__ballot_sync(0xffffffffu, mine == k)) - 1];
  cx = win.x;
  cy = win.y;
  cz = win.z;
  return (int)~(unsigned)k;
}

// A point's running distance after a step from (cx, cy, cz): the diff-square
// distance in the JAX order, min'd in unless the point is masked (-1).
__device__ __forceinline__ float update(float& slot, float4 p, float cx,
                                        float cy, float cz) {
  const float dx = __fsub_rn(p.x, cx);
  const float dy = __fsub_rn(p.y, cy);
  const float dz = __fsub_rn(p.z, cz);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  float cur = p.w;
  if (!(cur < 0.f)) {
    cur = d < cur ? d : cur;
    slot = cur;
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ dist_init,
                   int32_t* __restrict__ out, int n, int s_total,
                   int groups) {
  extern __shared__ float4 pts[];  // the chunk: x, y, z, running distance
  __shared__ Exchange ex[2];
  __shared__ unsigned long long wkey[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int r_total = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / r_total;
  const int offset = (b % groups) * n;  // K10: the slice's first row
  const int lo = (int)((long long)rank * n / r_total);
  const int len = (int)((long long)(rank + 1) * n / r_total) - lo;
  xyz += (size_t)b * n * 3;
  dist_init += (size_t)b * n;
  out += (size_t)b * s_total;

  // start: first-index argmax of the sentinel field (1e10 valid, -1 masked)
  float bv = -INFINITY;
  int bi = -1;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const size_t g = (size_t)(lo + j);
    const float d = dist_init[g];
    pts[j] = make_float4(xyz[3 * g], xyz[3 * g + 1], xyz[3 * g + 2], d);
    if (d > bv) {
      bv = d;
      bi = j;
    }
  }
  if (threadIdx.x == 0) {
    for (Exchange& x : ex)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&x.bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every block runs, its mbarriers set, before a store
  float cx, cy, cz;
  int far = cluster_argmax(cluster, bv, bi, lo, pts, wkey, ex, 0, cx, cy, cz);

  for (int s = 0; s < s_total; ++s) {
    if (rank == 0 && threadIdx.x == 0) out[s] = far + offset;
    if (s + 1 == s_total) break;
    bv = -INFINITY;
    bi = -1;
    // two points per pass, both loaded before either is used
    int j = threadIdx.x;
    for (; j + (int)blockDim.x < len; j += 2 * blockDim.x) {
      const float4 p0 = pts[j], p1 = pts[j + blockDim.x];
      const float d0 = update(pts[j].w, p0, cx, cy, cz);
      const float d1 = update(pts[j + blockDim.x].w, p1, cx, cy, cz);
      if (d0 > bv) {
        bv = d0;
        bi = j;
      }
      if (d1 > bv) {
        bv = d1;
        bi = j + blockDim.x;
      }
    }
    if (j < len) {
      const float d = update(pts[j].w, pts[j], cx, cy, cz);
      if (d > bv) {
        bv = d;
        bi = j;
      }
    }
    far = cluster_argmax(cluster, bv, bi, lo, pts, wkey, ex, s + 1, cx, cy,
                         cz);
  }
  cluster.sync();  // no block leaves while a store to it may be in flight
}

// Block size and dynamic shared memory of K1 for N points over `cluster`
// blocks: the largest chunk is ceil(N / cluster) points.
void cluster_shape(int n, int cluster, int* threads, size_t* smem) {
  const int chunk = (n + cluster - 1) / cluster;
  int t = (chunk + kPointsPerThread - 1) / kPointsPerThread;
  t = (t + 31) / 32 * 32;
  *threads = t < 32 ? 32 : (t > kThreads ? kThreads : t);
  *smem = (size_t)chunk * sizeof(float4);
}

cudaError_t cluster_config(int n, int cluster, int blocks, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return cudaErrorInvalidValue;
  int threads;
  size_t smem;
  cluster_shape(n, cluster, &threads, &smem);
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        fps_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// K1: xyz [B, N, 3] f32, dist_init [B, N] f32 -> out [B, S] int32, each
// cloud on a cluster of `cluster` blocks (1, 2, 4, 8 or 16).  A launch the
// card refuses returns its error; nothing falls back.
extern "C" int regnet_fps(const float* xyz, const float* dist_init,
                          int32_t* out, int batch, int n, int s_total,
                          int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(n, cluster, batch * cluster, stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, dist_init, out, n,
                             s_total, 1);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many K1 clusters of `cluster` blocks over N points the card holds at
// once (cudaOccupancyMaxActiveClusters); minus the CUDA error where it
// cannot launch them at all.
extern "C" int regnet_fps_max_clusters(int n, int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int count = 0;
  cudaError_t err = cluster_config(n, cluster, cluster, 0, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, fps_cluster_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused size is an answer here
    return -(int)err;
  }
  return count;
}

// K10: xyz [B, N, 3], dist_init [B, N] (each slice's own sentinel field),
// N and S multiples of `groups` -> out [B, S] int32, slice-major:
// out[b, g*S/G + i] = g*N/G + (i-th pick of slice g).  K1's kernel over
// the [B*G, N/G] view, each slice on a cluster of `cluster` blocks.
extern "C" int regnet_fps_grouped(const float* xyz, const float* dist_init,
                                  int32_t* out, int batch, int n, int s_total,
                                  int groups, int cluster,
                                  cudaStream_t stream) {
  if (groups < 1 || n % groups || s_total % groups)
    return (int)cudaErrorInvalidValue;
  const int slice = n / groups;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(slice, cluster, batch * groups * cluster,
                                   stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, dist_init, out,
                             slice, s_total / groups, groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

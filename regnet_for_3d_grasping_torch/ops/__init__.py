"""Point-cloud ops of the PyTorch port, with their CUDA kernels and the
kernels' plain PyTorch versions:

  K1  fps.fps                            csrc/fps.cu
  K2  ball_query.ball_query_bucketed     csrc/ball_query.cu
  K3  knn.three_nn_kernel                csrc/three_nn.cu
      (the keys split into ranges, grid by knn.split_grid: a split and,
      where there is more than one range, a merge)
  K4  pooling.gather_max                 csrc/gather_max.cu
      (forward, argmax form, and the first-winner backward shared with K9;
      each in f32 and bf16, as K9's two forms)
  K5  crop.closing_region_crop           csrc/crop.cu
      (K5, K11 and K2 share the bucket scan of csrc/bucket_scan.cuh, grid by
      bucket_scan.scan_grid: a scan and a fill, two launches a call)
  K6-K9  slab.*                          csrc/slab_select.cu,
                                         three_nn_slab.cu, gather_max_slab.cu
      (K6 and K7 build their span table and fill their empty slots on the
      card: three launches a call)
  K10 fps.fps_grouped                    csrc/fps.cu (K1's kernel, slices)
  K11 group.group_regions_fused          csrc/group.cu (no model path)
  K12 group.group_regions_chunked        csrc/grid_group.cu (the served
      grouping, the JAX package's chunked path: on a cell grid over the
      cloud, a build and a query, or for a call of few pairs one direct
      launch; group.route picks)
  K13 batch_norm.batch_norm              csrc/batch_norm.cu (BatchNorm +
      ReLU, the XLA fusions of the JAX package's flax BatchNorm: K13a
      statistics, K13b normalisation, K13c/K13d the backward; the module
      `batch_norm`, which nn/layers.BatchNorm calls on the card)

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; ``_cuda.launches`` counts the kernel launches.

The package exports the op library as the JAX ``ops`` package does.
``ball_query`` is both the submodule and, called, its function, as the
JAX package's export of that name shadows its module.
"""

from regnet_for_3d_grasping_torch.ops import ball_query  # noqa: F401
from regnet_for_3d_grasping_torch.ops import batch_norm  # noqa: F401
from regnet_for_3d_grasping_torch.ops.distances import (  # noqa: F401
    bpdist,
    bpdist2,
    pdist2,
)
from regnet_for_3d_grasping_torch.ops.fps import (  # noqa: F401
    farthest_point_sample,
)
from regnet_for_3d_grasping_torch.ops.grouping import (  # noqa: F401
    gather_points,
    group_points,
)
from regnet_for_3d_grasping_torch.ops.knn import (  # noqa: F401
    three_interpolate,
    three_nn,
)
from regnet_for_3d_grasping_torch.ops.pooling import gather_max  # noqa: F401
from regnet_for_3d_grasping_torch.ops.sampling import (  # noqa: F401
    bucket_choice,
    masked_random_choice,
)

__all__ = [
    "farthest_point_sample",
    "ball_query",
    "gather_max",
    "gather_points",
    "group_points",
    "three_nn",
    "three_interpolate",
    "bpdist",
    "bpdist2",
    "pdist2",
    "bucket_choice",
    "masked_random_choice",
]

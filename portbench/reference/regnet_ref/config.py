"""Configuration tree of the PyTorch port.

Its own copy of the JAX package's ``utils/config.py`` dataclasses, cut to
the fields that inference and training read.  The values and presets
(``train_config``, ``infer_config``, ``tiny_config``) are those of the JAX
package, so one override dict configures both packages alike.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GripperConfig:
    """Two-finger parallel gripper geometry (meters)."""

    width: float = 0.08    # max opening between fingers (y extent)
    height: float = 0.010  # hand thickness (z extent)
    depth: float = 0.06    # finger length along approach axis (x extent)
    # evaluator-side geometry, read by the synthetic scene generator
    finger_width: float = 0.01
    half_hand_thickness: float = 0.005
    finger_length: float = 0.06
    bottom_length: float = 0.06
    table_height: float = 0.75

    @property
    def hand_half_bottom_width(self) -> float:
        return self.width / 2 + self.finger_width

    @property
    def hand_half_bottom_space(self) -> float:
        return self.width / 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture (PointNet++ backbone plus the two heads)."""

    input_channels: int = 6          # xyz + rgb
    num_centroids: Tuple[int, ...] = (5120, 1024, 256)
    radii: Tuple[float, ...] = (0.02, 0.08, 0.32)
    num_neighbours: Tuple[int, ...] = (64, 64, 64)
    sa_channels: Tuple[Tuple[int, ...], ...] = (
        (128, 128, 256), (256, 256, 512), (512, 512, 1024))
    fp_channels: Tuple[Tuple[int, ...], ...] = (
        (1024, 1024), (512, 512), (256, 256, 256))
    num_fp_neighbours: Tuple[int, ...] = (3, 3, 3)
    seg_channels: Tuple[int, ...] = (512, 256, 256, 128)
    dropout_prob: float = 0.5        # seg head, training mode only
    num_anchors: int = 4
    reg_channels: int = 10
    feature_channels: int = 256
    refine_group_channels: int = 128
    # > 1: stratified approximate FPS at SA1 (ops/fps.py)
    fps_groups: int = 1
    # x-bound of the last FP's slab 3-NN, in the cloud's units (meters)
    fp3_nn_bound: float = 0.06
    # the full-scan SA layers' ball query: "bucket" (stratified) or "exact"
    # (the first K in-radius points in index order, the value-parity
    # setting); the slab ball query ignores it
    ball_query_method: str = "bucket"
    # "float32" or "bfloat16" (network compute; geometry stays f32)
    compute_dtype: str = "float32"
    # the score BatchNorm's momentum, torch convention (JAX
    # models/backbone.py:333); the JAX package reads bn_epsilon nowhere
    bn_momentum: float = 0.1
    bn_epsilon: float = 1e-5
    # recompute each SA/FP layer's activations in the backward
    # (`models/backbone.py`); the train CLI's --remat
    remat_backbone: bool = False


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """Proposal-region pipeline constants."""

    num_points: int = 25600
    center_num: int = 64         # 4000 at inference
    score_thre: float = 0.5
    group_num: int = 256
    group_num_more: int = 1024   # wide-region points; no model path reads it
    r_time_group: float = 0.1    # radius = max(gripper dims) * r_time
    r_time_group_more: float = 0.8   # the wide region's radius factor
    gripper_num: int = 64
    min_region_points: int = 5
    grasp_score_thre: float = 0.5
    accept_margin: float = 0.0
    refine_iters: int = 1
    refine_pose: str = "full"    # "full" | "center" | "off"
    # serving knobs (`geometry/region.select_score_centers`,
    # `models/regnet.pose_search_thetas` and `funnel_guard_refine`)
    center_min_z: float | None = None
    pose_search_k: int = 0
    pose_search_subsample: int = 4   # cloud stride of the search funnel
    pose_search_table: float = 0.75  # table plane of the funnels' survival
    refine_guard: bool = False
    refine_guard_subsample: int = 1  # 1: the funnel on the whole cloud
    center_fps_groups: int = 1
    center_select: str = "fps"
    slab_cell: float = 0.0
    max_gt_grasps: int = 512     # static pad of a scene's ground-truth grasps
    # threshold of the center <-> GT match, applied to the SQUARED distance
    # (a quirk of the reference that the JAX package keeps)
    gt_match_dist2: float = 0.005


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Constants of the geometric evaluator (``eval/``), which the
    synthetic scene generator's grasp labelling also reads."""

    num_points_threshold: int = 16
    close_region_min_points: int = 16
    back_collision_threshold: int = 0
    finger_collision_threshold: int = 0
    back_collision_margin: float = 0.0
    neighbor_depth: float = 0.005
    normal_radius: float = 0.01
    normal_max_nn: int = 30
    table_offset: float = 0.005
    max_grasps: int = 512


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 12
    epochs: int = 101
    lr_score: float = 1e-3
    lr_region: float = 1e-3
    lr_step_epochs: int = 5      # lr * gamma ** (epoch // lr_step_epochs)
    lr_gamma: float = 0.5
    seed: int = 1
    # the JAX package's mesh axis name (read nowhere there either; the
    # port names its axes in parallel/mesh.AXIS_NAMES)
    data_parallel_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    gripper: GripperConfig = dataclasses.field(default_factory=GripperConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    region: RegionConfig = dataclasses.field(default_factory=RegionConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @property
    def group_radius(self) -> float:
        g = self.gripper
        return max(g.width, g.height, g.depth) * self.region.r_time_group

    @property
    def group_radius_more(self) -> float:
        """The wide region's radius (`geometry.region.
        group_regions_two_scales`)."""
        g = self.gripper
        return max(g.width, g.height, g.depth) * self.region.r_time_group_more


def train_config(**overrides) -> PipelineConfig:
    """Reference training preset: 64 centers, batch 12."""
    return _override(PipelineConfig(), overrides)


def infer_config(**overrides) -> PipelineConfig:
    """Inference preset: 4000 centers."""
    cfg = PipelineConfig(region=RegionConfig(center_num=4000,
                                             group_num_more=2048))
    return _override(cfg, overrides)


def tiny_config(**overrides) -> PipelineConfig:
    """Small shapes for unit tests."""
    cfg = PipelineConfig(
        model=ModelConfig(num_centroids=(128, 32, 16),
                          num_neighbours=(8, 8, 8),
                          sa_channels=((16, 16, 32), (32, 32, 64),
                                       (64, 64, 128)),
                          fp_channels=((128, 128), (64, 64), (32, 32, 32)),
                          seg_channels=(32, 32, 32, 32),
                          feature_channels=32,
                          refine_group_channels=16),
        region=RegionConfig(num_points=512, center_num=8, group_num=16,
                            group_num_more=32, gripper_num=16,
                            max_gt_grasps=32),
        eval=EvalConfig(max_grasps=32),
        train=TrainConfig(batch_size=2),
    )
    return _override(cfg, overrides)


def _override(cfg: PipelineConfig, overrides: dict) -> PipelineConfig:
    """Apply {'region.center_num': 4000}-style overrides."""
    for key, val in overrides.items():
        section, _, field = key.partition(".")
        try:
            sub = dataclasses.replace(getattr(cfg, section), **{field: val})
        except (AttributeError, TypeError) as e:
            raise KeyError(f"unknown config override {key!r}") from e
        cfg = dataclasses.replace(cfg, **{section: sub})
    return cfg

"""Grasp geometry of the port, exported as the JAX package's ``geometry``
exports it."""

from regnet_for_3d_grasping_torch.geometry.codec import (  # noqa: F401
    anchor_templates,
    cos_dissimilarity,
    frames_to_grasps,
    grasps_to_frames,
)
from regnet_for_3d_grasping_torch.geometry.region import (  # noqa: F401
    closing_region_crop,
    closing_region_crop_dense,
    group_regions,
    group_regions_two_scales,
    select_score_centers,
)
from regnet_for_3d_grasping_torch.geometry.gt import (  # noqa: F401
    match_centers_to_gt,
)

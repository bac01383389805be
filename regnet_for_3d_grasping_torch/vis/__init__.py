"""Grasp visualization of the port, exported as the JAX package's ``vis``
exports it."""

from regnet_for_3d_grasping_torch.vis.vis_grasp import (  # noqa: F401
    gripper_hand_boxes,
    show_grasp,
    write_ply,
)

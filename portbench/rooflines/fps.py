"""Farthest point sampling, kernels K1 (``ops/fps.fps``) and K10
(``ops/fps.fps_grouped``): each step measures every point of the cloud (or
of its slice) against the last pick and takes the farthest.  Read once: the
points' xyz and the sentinel field; written once: the picks.  Operations: 10
a point a step (three differences, three squares, two adds, the running
min, the argmax's compare)."""

TARGETS = [("regnet_for_3d_grasping_torch.ops.fps", "fps"),
           ("regnet_for_3d_grasping_torch.ops.fps", "fps_grouped")]
OPS_PER_POINT_STEP = 10


def cost(args, kwargs, out):
    """-> [(bytes, operations, dtype)] of the call: fps(xyz [B, N, 3],
    dist [B, N], S) or fps_grouped(xyz, dist, S, G)."""
    xyz, _, samples = args[:3]
    groups = args[3] if len(args) > 3 else kwargs.get("groups", 1)
    B, N, _ = xyz.shape
    nbytes = B * N * 16 + B * samples * 4
    ops = OPS_PER_POINT_STEP * B * samples * (N // groups)
    return [(nbytes, ops, "float32")]

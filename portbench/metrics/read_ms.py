"""Input pipeline: host milliseconds a step in the port's span
``data.read`` (``GraspDataset``'s scene pickles read, ``load_scene``)."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "train", lambda t: span(t, "data.read", "host_ms"))

"""Input pipeline: host milliseconds a step of the port's span
``data.prep`` less its reads (``GraspDataset.batches``: resampling, colour
augmentation, the padded ground truth and the stacks)."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "train", lambda t: span(t, "data.prep", "self_ms"))

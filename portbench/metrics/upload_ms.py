"""Input pipeline: host milliseconds a step in the port's span
``data.upload`` (``trainer.device_batch``: the batch copied to the card,
each copy from pageable memory waiting for the card)."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "train", lambda t: span(t, "data.upload", "host_ms"))

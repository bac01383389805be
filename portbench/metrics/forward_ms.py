"""A training step's forward: milliseconds a step of the port's span
``forward`` (``train_step``: the forward with its three stages, the GT
match and the losses), the stage's wall time on the card's stream, from the
CUDA event at its start to the one at its end: the stream's idle gaps
inside it count, so where the host paces the card this is mostly the host's
pace, not the card's work, and it does not rank the stages by device work."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "train",
                    lambda t: span(t, "forward", "stream_ms"))

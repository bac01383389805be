"""RefineNet, the last of REGNet's stages: milliseconds a forward of the
port's span ``rn`` (the closing-region crops, pools and ``RefineHead``, the
guard and the acceptance), the stage's wall time on the card's stream, from
the CUDA event at its start to the one at its end: the stream's idle gaps
inside it count, so where the host paces the card this is mostly the host's
pace, not the card's work, and it does not rank the stages by device work."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "serve",
                    lambda t: span(t, "rn", "stream_ms"))

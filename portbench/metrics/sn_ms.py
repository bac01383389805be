"""ScoreNet, the first of REGNet's stages: milliseconds a forward of the
port's span ``sn`` (``REGNet.forward``: the backbone, the seg head and the
score, with the slab sort where slab mode sorts first), the stage's wall
time on the card's stream, from the CUDA event at its start to the one at
its end: the stream's idle gaps inside it count, so where the host paces
the card this is mostly the host's pace, not the card's work, and it does
not rank the stages by device work."""

from portbench.metrics._program import per_unit, span


def read(ctx):
    return per_unit(ctx, "serve",
                    lambda t: span(t, "sn", "stream_ms"))

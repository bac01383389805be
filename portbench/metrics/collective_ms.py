"""Collectives (data parallelism): device milliseconds a step of the
averaging over the ranks (``trainer.average_over_mesh`` inside
``parallel/mesh.Mesh.timed``: CUDA events around the gradients', the
statistics' and the metrics' all-reduce, the wait for the slowest rank
included), the mean a step over the ranks (``Mesh.collective_ms``)."""


def read(ctx):
    return ctx.get("collective_ms")

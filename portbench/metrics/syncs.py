"""Device-to-host waits: the port's counted waits for the card a request
or a step (``utils/trace.to_host`` and ``waiting``)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, None, lambda t: t["syncs"])

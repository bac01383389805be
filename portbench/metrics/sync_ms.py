"""Device-to-host waits: host milliseconds a request or a step blocked in
the port's counted waits for the card (``utils/trace.to_host`` and
``waiting``: the extraction's reads, uploads from pageable memory, tensors
made from Python values on the card, the reads of device values)."""

from portbench.metrics._program import per_unit


def read(ctx):
    return per_unit(ctx, None, lambda t: t["wait_ms"])

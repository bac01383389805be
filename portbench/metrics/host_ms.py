"""Serving entry, the launch path: host milliseconds a request in the
port's spans ``regnet`` (``REGNet.forward``) and ``extract``
(``extract_grasp_sets``), less the seconds they spent blocked in counted
waits for the card."""

from portbench.metrics._program import per_unit, span


def host(tot):
    parts = [(span(tot, n, "host_ms"), span(tot, n, "wait_ms"))
             for n in ("regnet", "extract")]
    if any(h is None for h, _ in parts):
        return None
    return sum(h - w for h, w in parts)


def read(ctx):
    return per_unit(ctx, "serve", host)

"""What the port's own tracing (``regnet_for_3d_grasping_torch/utils/
trace.py``: its spans and counters, recorded while the profiler records)
holds after the traced window, a forward or a step at a time, for the
readers of its metrics.  Nothing where the port has no such module or
recorded nothing there."""

import importlib

MODULE = "regnet_for_3d_grasping_torch.utils.trace"


def totals():
    """The module's totals; None where the port has no such module (a
    fault inside it raises)."""
    try:
        trace = importlib.import_module(MODULE)
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return None
    return trace.totals()


def per_unit(ctx, mode, value):
    """`value` (a function of the totals, None where it finds nothing) a
    forward or a step of the window, in `mode` ("serve", "train" or None
    for both)."""
    if (mode is not None and ctx["mode"] != mode) or not ctx["per_unit"]:
        return None
    tot = totals()
    if not tot or not tot["spans"]:
        return None
    v = value(tot)
    return None if v is None else v / ctx["per_unit"]


def span(tot, name, key):
    """The span `name`'s `key` (``host_ms``, ``self_ms``, ``stream_ms``,
    ``wait_ms``), None where it did not run."""
    s = tot["spans"].get(name)
    return None if s is None else s[key]

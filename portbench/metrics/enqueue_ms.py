"""Serving entry: host milliseconds from ``REGNet.forward``'s call to its
return, before the result is synchronized, a forward (the harness's
``forward`` span; where the forward waits on the card inside, that wait
counts).  Moves the latency (``.latency``) or the clouds a second
(``.batch``)."""


def read(ctx):
    if ctx["mode"] != "serve" or not ctx["per_unit"]:
        return None
    return ctx["spans"].total_ms("forward") / ctx["per_unit"]

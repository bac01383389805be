"""Device: the share of the traced window in which no operation ran on
the card (1 - the union of its activity intervals over the window), in
%."""


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

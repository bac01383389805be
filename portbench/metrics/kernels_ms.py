"""The port's hand-written kernels (``csrc/*.cu``, K1-K13f): their device
milliseconds a forward or a step, from the profile."""


def read(ctx):
    if not ctx.get("units") or not ctx.get("own_s"):
        return None
    return 1e3 * ctx["own_s"] / ctx["units"]

"""The counted functions' share of their roofline, in %: the sum of each
call's bound (``rooflines/*.py``: the larger of its bytes over 3.35 TB/s
and its operations over the dtype's peak) over the device seconds of the
kernels the calls launched (forward inside the function's range, backward
by the autograd nodes of its operations).  Nothing when no counted
function ran on the card."""


def read(ctx):
    roof = ctx.get("roofline") or {}
    bound = sum(b for b, d in roof.values() if d > 0)
    device = sum(d for _, d in roof.values())
    if device <= 0:
        return None
    return 100.0 * bound / device

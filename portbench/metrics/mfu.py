"""The model step's share of the card's peak: the dense layers' FLOPs at
the cell's shapes (``portbench/flops.py``; three times the forward's for a
training step) over the traced window's seconds, over the peak of the
configuration's compute dtype (67 TFLOP/s f32, 989 TFLOP/s bf16), in %."""


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("busy_s"):
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / ctx["peak_flops"]

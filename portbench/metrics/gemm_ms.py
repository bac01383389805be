"""Dense layers: device milliseconds of cuBLAS's matrix-product kernels a
forward (serving) or a step (training), from the profile."""


def read(ctx):
    if not ctx.get("units") or not ctx.get("gemm_s"):
        return None
    return 1e3 * ctx["gemm_s"] / ctx["units"]

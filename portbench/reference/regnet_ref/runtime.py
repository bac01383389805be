"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Never falls back to the CPU when no card is present.

    Also turns TF32 off for matrix products and convolutions: the JAX
    package computes all geometry in full f32 (``Precision.HIGHEST``), and
    TF32's 10-bit mantissa would flip which points fall inside a radius.
    bf16 products (a bf16 compute dtype) keep f32 accumulation, as XLA's
    do: cuBLAS's reduced-precision reduction is off.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev

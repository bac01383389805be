"""PyTorch/CUDA port of REGNet for NVIDIA Hopper.

Single-cloud inference at the reference preset: `models.regnet.build_regnet`
and the CLI ``python -m regnet_for_3d_grasping_torch.cli.infer``.  The five
kernels of that path are CUDA sources under ``csrc/``, built with ``nvcc``
at first use (see ``ops/_cuda.py``).
"""

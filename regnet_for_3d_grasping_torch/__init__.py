"""PyTorch/CUDA port of REGNet for NVIDIA Hopper.

Inference at the reference preset (`models.regnet.build_regnet`, the CLI
``python -m regnet_for_3d_grasping_torch.cli.infer``, full scan or sorted
slab, its grasp sets through the geometric evaluator of ``eval/``),
training at the reference training preset (``python -m
regnet_for_3d_grasping_torch.cli.train``) and quality on the frozen
benchmark suite (``python -m
regnet_for_3d_grasping_torch.cli.benchmark_eval``).  The entry points use
every visible card, as the JAX package's use every device: the infer
CLI's ``--dp`` serves one cloud per card, the train CLI trains
data-parallel where the batch splits over the cards, and the grasp
evaluation spreads one scene per card (``parallel/``).  The kernels of
those paths are CUDA sources under ``csrc/``, built with ``nvcc`` at first
use (see ``ops/_cuda.py``).
"""

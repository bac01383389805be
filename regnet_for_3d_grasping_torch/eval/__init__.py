"""The geometric evaluator (JAX ``eval/``): view and scene collision checks,
the antipodal score, normals, and the VGR / score records they add up to.

No TPU kernel backs it: the JAX package computes it in XLA, and the port in
PyTorch on tensors, on the card unless the caller asks for the CPU."""

"""Point-cloud ops of the PyTorch port, with the five CUDA kernels of the
inference path and their plain PyTorch versions:

  K1 fps.fps                            csrc/fps.cu
  K2 ball_query.ball_query_bucketed     csrc/ball_query.cu
  K3 knn.three_nn_kernel                csrc/three_nn.cu
  K4 pooling.gather_max                 csrc/gather_max.cu
  K5 crop.closing_region_crop           csrc/crop.cu

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; ``_cuda.launches`` counts the kernel launches.
"""

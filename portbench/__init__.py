"""The benchmark of the PyTorch port (``regnet_for_3d_grasping_torch``):
``run.py`` runs one cell of ``BENCHMARK.json`` once.  See PERF.md."""

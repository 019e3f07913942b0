"""Benchmarks of the PyTorch/CUDA port (``src/repro_torch``)."""

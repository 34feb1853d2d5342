"""Part of the benchmark of the PyTorch and CUDA port; see gpubench/README.md."""

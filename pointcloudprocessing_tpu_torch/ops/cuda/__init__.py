"""Wrappers of the hand-written CUDA kernels in ``csrc/``, each beside its
plain PyTorch version (counterparts of ``pointcloudprocessing_tpu/ops/pallas``)."""

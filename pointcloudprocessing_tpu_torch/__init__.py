"""pointcloudprocessing_tpu_torch — the PyTorch and CUDA port of
``pointcloudprocessing_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: each module here names its JAX
counterpart, and the tests hold the two against each other on the CPU. The
port imports ``torch``, numpy and the standard library, never JAX and
nothing of the JAX package: ``core`` (config schema, constants) and
``utils`` (the native frame parser's loader) are its own copies.

- ``core``:   the config schema and constants.
- ``ops``:    normalization, jitter, Morton keys, voxel downsample, FPS and
              the stride sampler, kNN, PCA normals (exact and windowed),
              row gathers; ``ops/cuda/`` binds the hand-written kernels in
              ``csrc/`` (segment sum, FPS, pooled chain, window moments,
              gather max/min) and their plain versions.
- ``models``: the multi-head PointNet (inference and train mode), its
              T-Nets and blocks, DGCNN (inference and train-mode forward),
              ``model_from_config`` (on CUDA unless asked for the CPU) and
              ``PointCloudPipeline`` (scans -> voxel -> sampler -> model).
- ``train``:  the losses and the single-device train, eval and predict
              steps (Adam with freeze masks).
- ``data``:   AftrBurner frame parsing and writing.
- ``utils``:  the loader of the repo's C++ frame scanner.
- ``convert``: Flax variables <-> PyTorch ``state_dict``.
- ``serve``:  the serving CLI.
"""

__version__ = "0.1.0"

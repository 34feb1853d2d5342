"""pointcloudprocessing_tpu_torch — the PyTorch and CUDA port of
``pointcloudprocessing_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: each module here names its JAX
counterpart, and the tests hold the two against each other on the CPU. The
port imports ``torch``, numpy and the standard library, plus the JAX
package's backend-free ``core`` (config schema, constants) and ``utils``
(native frame parser) modules; it never imports JAX.

- ``ops``:    normalization, jitter, Morton keys, voxel downsample, FPS and
              the stride sampler; ``ops/cuda/`` binds the hand-written
              kernels in ``csrc/`` (segment sum, FPS, pooled chain) and
              their plain versions.
- ``models``: the multi-head PointNet (inference and train mode), its
              T-Nets and blocks, and ``PointCloudPipeline`` (scans -> voxel
              -> sampler -> model).
- ``train``:  the losses and the single-device train, eval and predict
              steps (Adam with freeze masks).
- ``data``:   AftrBurner frame parsing and writing.
- ``convert``: Flax variables <-> PyTorch ``state_dict``.
- ``serve``:  the serving CLI.
"""

__version__ = "0.1.0"

"""pointcloudprocessing_tpu_torch — the PyTorch and CUDA port of
``pointcloudprocessing_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: each module here names its JAX
counterpart, and the tests hold the two against each other on the CPU. The
port imports ``torch``, numpy and the standard library, never JAX and
nothing of the JAX package: the modules it needs from there (the config
schema, constants, the native helpers' loader, the TFRecord codec, the
dataset manager) are its own copies.

- ``core``:   the config schema and constants.
- ``ops``:    normalization, jitter and random rotations, Morton keys,
              voxel downsample, FPS and the stride sampler, kNN, PCA
              normals (exact and windowed), row gathers, fixed-width
              resampling, SO(3)/SE(3) math, ICP, hidden-point removal;
              ``ops/cuda/`` binds the hand-written kernels in
              ``csrc/`` (segment sum, FPS, pooled chain, window moments,
              gather max/min) and their plain versions.
- ``models``: the multi-head PointNet (inference and train mode), its
              T-Nets and blocks, DGCNN (inference and train-mode forward),
              ``model_from_config`` (on CUDA unless asked for the CPU),
              ``PointCloudPipeline`` (scans -> voxel -> sampler -> model,
              on one device or sharded over several),
              and the legacy classifier and T-Net regressor.
- ``train``:  the losses, the train, eval and predict steps for every
              family (Adam with freeze masks; single-device, and the global
              and shard_map multi-device modes), the callbacks on torch
              checkpoints, the staged trainer ``TrainProfile`` and its CLI
              (``python -m pointcloudprocessing_tpu_torch.train.cli``, also
              under ``torchrun``), and the optimizer-by-rate grid
              (``train/hypertune.py``).
- ``parallel``: process groups (NCCL, or gloo when asked for), the
              process-group and in-process meshes, row shares, state
              broadcast and group batch statistics.
- ``data``:   AftrBurner frames and pose logs, the TFRecord codec,
              ``PointCloudSet`` (ingest, splits) and the batch loaders.
- ``synthesis``: meshes, procedural shapes, viewpoint observations with
              hidden-point removal (``MeshSampler``) and collect writing.
- ``utils``:  the loader of the repo's C++ runtime helpers, and the
              profiling hooks.
- ``convert``: Flax variables <-> PyTorch ``state_dict``.
- ``serve``:  the serving CLI.
"""

__version__ = "0.1.0"

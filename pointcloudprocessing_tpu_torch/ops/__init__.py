"""Point-cloud ops of the port (counterparts of
``pointcloudprocessing_tpu/ops``); ``ops/cuda`` holds the kernel wrappers.

As in the JAX package, ``knn`` and ``icp`` here are the functions, which
hide their submodules' names: reach the modules with
``importlib.import_module("pointcloudprocessing_tpu_torch.ops.knn")``."""

from pointcloudprocessing_tpu_torch.ops import mat_ops
from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere
from pointcloudprocessing_tpu_torch.ops.resample import (
    adjust_to_input_width_np,
    adjust_to_input_width,
)
from pointcloudprocessing_tpu_torch.ops.augment import jitter
from pointcloudprocessing_tpu_torch.ops.voxel import (
    voxel_downsample,
    voxel_downsample_batch,
)
from pointcloudprocessing_tpu_torch.ops.fps import (
    farthest_point_sample,
    farthest_point_sample_and_gather,
    stride_sample_and_gather,
    farthest_point_sample_batch,
)
from pointcloudprocessing_tpu_torch.ops.knn import knn, knn_batch, group_points
from pointcloudprocessing_tpu_torch.ops.normals import (
    estimate_normals,
    estimate_normals_batch,
)
from pointcloudprocessing_tpu_torch.ops.hpr import (
    hidden_point_removal,
    hidden_point_removal_mask,
    spherical_flip,
)
from pointcloudprocessing_tpu_torch.ops.icp import icp

__all__ = [
    "mat_ops",
    "normalize_unit_sphere",
    "adjust_to_input_width_np",
    "adjust_to_input_width",
    "jitter",
    "voxel_downsample",
    "voxel_downsample_batch",
    "farthest_point_sample",
    "farthest_point_sample_and_gather",
    "stride_sample_and_gather",
    "farthest_point_sample_batch",
    "knn",
    "knn_batch",
    "group_points",
    "estimate_normals",
    "estimate_normals_batch",
    "hidden_point_removal",
    "hidden_point_removal_mask",
    "spherical_flip",
    "icp",
]

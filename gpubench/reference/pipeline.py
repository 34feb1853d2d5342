"""The serving path, a copy of the semantics of
``pointcloudprocessing_tpu_torch/models/pipeline.py::PointCloudPipeline``
with a voxel size and the FPS sampler: voxel downsample, FPS to the model's
width over the occupied voxels, the model's heads."""

from __future__ import annotations

from typing import Callable

import torch

from gpubench.reference.fps import farthest_point_sample
from gpubench.reference.voxel import voxel_downsample


def preprocess(scans: torch.Tensor, voxel_size: float, model_width: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(b, n, 3) scans -> (sampled (b, model_width, 3), occupied voxels (b,))."""
    voxels, valid = voxel_downsample(scans, voxel_size)
    return farthest_point_sample(voxels, model_width, valid)[1], valid.sum(dim=1)


def serve(model: Callable, scans: torch.Tensor, voxel_size: float,
          model_width: int) -> dict[str, torch.Tensor]:
    """The heads that the serving path gives for ``scans``."""
    return model(preprocess(scans, voxel_size, model_width)[0])

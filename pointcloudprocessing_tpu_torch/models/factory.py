"""Model construction from a TrainConfig
(``pointcloudprocessing_tpu/models/factory.py::model_from_config``)."""

from __future__ import annotations

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.models.dgcnn import dgcnn_for_width
from pointcloudprocessing_tpu_torch.models.layers import require_device
from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
from pointcloudprocessing_tpu_torch.models.pointnet2 import pointnet2_for_width

MODEL_FAMILIES = ("pointnet", "pointnet2", "dgcnn")


def model_from_config(cfg, *, training: bool = False, dropout_rate: float = 0.3,
                      generator: torch.Generator | None = None,
                      device="cuda") -> nn.Module:
    """Build the configured model family (``cfg`` is a
    ``core.config.TrainConfig``): PointNet, PointNet++ or DGCNN, on
    ``device``, which is CUDA unless the caller asks for the CPU (without
    CUDA the default raises). ``training=True`` applies the config's T-Net regularizers
    (PointNet only); inference consumers build without them."""
    opts = dict(getattr(cfg, "model_options", {}) or {})
    if cfg.model != "dgcnn" and opts:
        raise ValueError(
            f"params.model_options is not supported for params.model="
            f"{cfg.model!r} (got {sorted(opts)})"
        )
    if cfg.model == "pointnet2":
        return pointnet2_for_width(
            cfg.num_classes, cfg.num_parts, cfg.input_width,
            dropout_rate=dropout_rate, generator=generator, device=device,
        )
    if cfg.model == "dgcnn":
        unknown = set(opts) - {"k", "graph"}
        if unknown:
            raise ValueError(
                f"Unknown params.model_options keys for dgcnn: "
                f"{sorted(unknown)} (supported: 'k', 'graph')"
            )
        extra = {}
        if "k" in opts:
            extra["k"] = int(opts["k"])
        if "graph" in opts:
            extra["graph"] = str(opts["graph"])
        return dgcnn_for_width(
            cfg.num_classes, cfg.num_parts, cfg.input_width,
            dropout_rate=dropout_rate, generator=generator, device=device,
            **extra,
        )
    if cfg.model == "pointnet":
        return PointNet(
            cfg.num_classes, cfg.num_parts, vanilla=cfg.vanilla,
            dropout_rate=dropout_rate,
            regularize_input_transform=(
                cfg.regularize_input_transform if training else False),
            regularize_feature_transform=(
                cfg.regularize_feature_transform if training else False),
            generator=generator, device=require_device(device),
        )
    raise ValueError(
        f"Unknown params.model {cfg.model!r} (expected one of {MODEL_FAMILIES})"
    )

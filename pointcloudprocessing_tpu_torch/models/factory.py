"""Model construction from a TrainConfig
(``pointcloudprocessing_tpu/models/factory.py::model_from_config``)."""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

MODEL_FAMILIES = ("pointnet", "pointnet2", "dgcnn")
_NOT_PORTED = {
    "pointnet2": "ROADMAP queue 1 item 8 (PointNet++)",
    "dgcnn": "ROADMAP queue 1 item 9 (DGCNN)",
}


def model_from_config(cfg, *, training: bool = False, dropout_rate: float = 0.3,
                      generator: torch.Generator | None = None,
                      device=None) -> PointNet:
    """Build the configured model family (``cfg`` is a
    ``core.config.TrainConfig``); only the PointNet family is ported.
    ``training=True`` applies the config's T-Net regularizers; inference
    consumers build without them."""
    opts = dict(getattr(cfg, "model_options", {}) or {})
    if cfg.model != "dgcnn" and opts:
        raise ValueError(
            f"params.model_options is not supported for params.model="
            f"{cfg.model!r} (got {sorted(opts)})"
        )
    if cfg.model in _NOT_PORTED:
        raise NotImplementedError(
            f"params.model={cfg.model!r} is not ported yet: {_NOT_PORTED[cfg.model]}"
        )
    if cfg.model == "pointnet":
        return PointNet(
            cfg.num_classes, cfg.num_parts, vanilla=cfg.vanilla,
            dropout_rate=dropout_rate,
            regularize_input_transform=(
                cfg.regularize_input_transform if training else False),
            regularize_feature_transform=(
                cfg.regularize_feature_transform if training else False),
            generator=generator, device=device,
        )
    raise ValueError(
        f"Unknown params.model {cfg.model!r} (expected one of {MODEL_FAMILIES})"
    )

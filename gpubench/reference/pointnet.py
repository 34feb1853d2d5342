"""Multi-head PointNet (Qi et al. 2017, arXiv:1612.00593) as a function of a
dict of named tensors: a copy of the semantics of
``pointcloudprocessing_tpu_torch/models/pointnet.py``, ``layers.py``,
``tnet.py`` and ``ops/normalize.py``, with the names of that module's
``state_dict`` so one set of weights serves both.

Unit-sphere normalization, input T-Net (3x3), shared MLP(64, 64), feature
T-Net (64x64), MLP(64, 128, 1024), global max-pool, a classification head
(512 -> dropout -> 256 -> dropout -> softmax) and a segmentation head on
[per-point 64 ++ global 1024] (512 -> 256 -> 128 -> 128 -> softmax); the
SE(3) head is the input transform. BatchNorm (epsilon 1e-3) normalizes by
the running statistics in eval mode and by the batch's (biased variance,
over every axis but the last) in train mode. Dropout keeps a value where
``rand < 1 - rate`` and scales it by ``1 / (1 - rate)``.

Departures from the published network: none in the equations; the weights
are named as the program names them, and the segmentation head's input is
built as the concat the paper describes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3
NORMALIZATION_EPSILON = 1e-7
HEADS = ("classification_output", "segmentation_output", "se3")


def normalize_unit_sphere(points: torch.Tensor) -> torch.Tensor:
    centered = points - points.mean(dim=-2, keepdim=True)
    dist = torch.sqrt(torch.square(centered).sum(dim=-1))
    scale = torch.clamp(dist.amax(dim=-1, keepdim=True)[..., None], min=NORMALIZATION_EPSILON)
    return centered / scale


def batch_norm(w: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = torch.square(x - mean).mean(dim=axes)
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    scale = torch.rsqrt(var + BN_EPSILON) * w[f"{name}.weight"]
    return (x - mean) * scale + w[f"{name}.bias"]


def block(w: dict, name: str, x: torch.Tensor, train: bool, dense: str = "conv",
          bn: bool = True, activation: str | None = "relu") -> torch.Tensor:
    """Dense (a bias only without BN), BatchNorm, activation."""
    x = F.linear(x, w[f"{name}.{dense}.weight"], w.get(f"{name}.{dense}.bias"))
    if bn:
        x = batch_norm(w, f"{name}.bn", x, train)
    if activation == "relu":
        return torch.relu(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    return x


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def tnet(w: dict, name: str, x: torch.Tensor, k: int, train: bool) -> torch.Tensor:
    """(b, n, k) -> (b, k, k): conv 64, 128, 1024, max over points, dense
    512, 256, then ``h @ w + b``."""
    h = block(w, f"{name}.conv_layer_1", x, train)
    h = block(w, f"{name}.conv_layer_2", h, train)
    h = block(w, f"{name}.conv_layer_3", h, train).amax(dim=1)
    h = block(w, f"{name}.dense_layer_1", h, train, dense="dense")
    h = block(w, f"{name}.dense_layer_2", h, train, dense="dense")
    return (h @ w[f"{name}.w"]).reshape(-1, k, k) + w[f"{name}.b"]


def orthogonality_loss(transform: torch.Tensor) -> torch.Tensor:
    """``1e-3 * sum((I - X X^T)^2) / 2`` over the batch."""
    k = transform.shape[-1]
    eye = torch.eye(k, dtype=transform.dtype, device=transform.device)
    return 1e-3 * 0.5 * torch.square(eye - transform @ transform.transpose(-1, -2)).sum()


def forward(w: dict, points: torch.Tensor, *, train: bool = False,
            dropout_rate: float = 0.3, generator: torch.Generator | None = None,
            regularize: tuple[bool, bool] = (False, False)
            ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """points (b, n, 3) -> (the three heads, the T-Net regularizers that
    ``regularize`` turns on, input and feature)."""
    pc = normalize_unit_sphere(points)
    reg = torch.zeros((), dtype=pc.dtype, device=pc.device)
    r = tnet(w, "input_transform", pc, 3, train)
    if regularize[0]:
        reg = reg + orthogonality_loss(r)
    x = block(w, "mlp_1_1", pc @ r, train)
    x = block(w, "mlp_1_2", x, train)
    r64 = tnet(w, "feature_transform", x, 64, train)
    if regularize[1]:
        reg = reg + orthogonality_loss(r64)
    local = x @ r64
    x = block(w, "mlp_2_1", local, train)
    x = block(w, "mlp_2_2", x, train)
    global_features = block(w, "mlp_2_3", x, train).amax(dim=1)  # (b, 1024)

    c = block(w, "mlp_cls_1", global_features, train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    c = block(w, "mlp_cls_2", c, train, dense="dense")
    if train:
        c = dropout(c, dropout_rate, generator)
    cls = block(w, "mlp_cls_3", c, train, dense="dense", bn=False, activation="softmax")

    tiled = global_features[:, None, :].expand(-1, local.shape[1], -1)
    s = block(w, "mlp_seg_1", torch.cat([local, tiled], dim=-1), train)
    for name in ("mlp_seg_2", "mlp_seg_3", "mlp_seg_4"):
        s = block(w, name, s, train)
    seg = block(w, "mlp_seg_5", s, train, bn=False, activation="softmax")
    return {"classification_output": cls, "segmentation_output": seg, "se3": r}, reg

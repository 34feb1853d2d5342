"""The legacy classification-only PointNet and the T-Net pretrainer
(``pointcloudprocessing_tpu/models/classifier.py``).

- :class:`PointNetClassifier`: no input normalization, a legacy input T-Net
  (3x3) and feature T-Net (64x64, with its orthogonality regularizer),
  MLP(64, 64), MLP(64, 128, 1024), a global max, and a dense head
  512 -> dropout -> 256 -> dropout -> softmax. The legacy T-Net's convs have
  no BatchNorm and no activation, and its ``w`` starts at zero, so an
  untrained T-Net is the identity.
- :class:`TNetRegressor`: a lone legacy input T-Net that regresses a
  rotation matrix.

``mlp_2_3`` and its max are a plain block and a plain ``amax``, as the JAX
model computes them; they do not take the pooled-chain kernels. Submodule
names are the Flax module names, so ``convert.py`` maps both trees.
Parameters are drawn on the CPU from ``generator`` and placed on ``device``
(CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_MOMENTUM
from pointcloudprocessing_tpu_torch.models.layers import (
    DenseBlock,
    PointwiseBlock,
)
from pointcloudprocessing_tpu_torch.models.pointnet import dropout
from pointcloudprocessing_tpu_torch.models.tnet import TNet, orthogonality_loss
from pointcloudprocessing_tpu_torch.utils.device import require_device


def _legacy_tnet(k: int, add_regularization: bool, **kw) -> TNet:
    return TNet(k, add_regularization, conv_apply_bn=False,
                conv_activation=None, w_init_zeros=True, **kw)


class PointNetClassifier(nn.Module):
    def __init__(self, num_classes: int = 2, dropout_rate: float = 0.3,
                 bn_momentum: float = KERAS_BN_MOMENTUM, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.dropout_rate = dropout_rate
        kw = dict(bn_momentum=bn_momentum, generator=generator,
                  device=require_device(device))
        self.input_transform = _legacy_tnet(3, False, **kw)
        self.mlp_1_1 = PointwiseBlock(3, 64, **kw)
        self.mlp_1_2 = PointwiseBlock(64, 64, **kw)
        self.feature_transform = _legacy_tnet(64, True, **kw)
        self.mlp_2_1 = PointwiseBlock(64, 64, **kw)
        self.mlp_2_2 = PointwiseBlock(64, 128, **kw)
        self.mlp_2_3 = PointwiseBlock(128, 1024, **kw)
        self.dense_1 = DenseBlock(1024, 512, apply_bn=True, activation="relu", **kw)
        self.dense_2 = DenseBlock(512, 256, apply_bn=True, activation="relu", **kw)
        self.dense_out = DenseBlock(256, num_classes, activation="softmax", **kw)

    def forward(self, points: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """points (b, n, 3) -> (b, num_classes) softmax probabilities; in
        train mode the dropout masks come from ``generator``."""
        return self.forward_with_reg(points, train=train, generator=generator)[0]

    def forward_with_reg(self, points: torch.Tensor, *, train: bool = False,
                         generator: torch.Generator | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The probabilities and the feature T-Net's orthogonality term."""
        x = points @ self.input_transform(points, train=train)
        x = self.mlp_1_1(x, train=train)
        x = self.mlp_1_2(x, train=train)
        r64 = self.feature_transform(x, train=train)
        x = x @ r64
        x = self.mlp_2_1(x, train=train)
        x = self.mlp_2_2(x, train=train)
        x = self.mlp_2_3(x, train=train).amax(dim=-2)  # (b, 1024)
        x = self.dense_1(x, train=train)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        x = self.dense_2(x, train=train)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return self.dense_out(x, train=train), orthogonality_loss(r64)


class TNetRegressor(nn.Module):
    def __init__(self, add_regularization: bool = False,
                 bn_momentum: float = KERAS_BN_MOMENTUM,
                 tnet_layer_widths: tuple[int, ...] = (64, 128, 1024, 512, 256), *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.input_transform = _legacy_tnet(
            3, add_regularization, layer_widths=tnet_layer_widths,
            bn_momentum=bn_momentum, generator=generator,
            device=require_device(device))

    def forward(self, points: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """points (b, n, 3) -> (b, 3, 3) predicted rotation."""
        return self.input_transform(points, train=train)

    def forward_with_reg(self, points: torch.Tensor, *, train: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """The rotation and its orthogonality term (0 without
        ``add_regularization``)."""
        r = self(points, train=train)
        if self.input_transform.add_regularization:
            return r, orthogonality_loss(r)
        return r, torch.zeros((), dtype=r.dtype, device=r.device)

"""T-Net: learned KxK feature transform
(``pointcloudprocessing_tpu/models/tnet.py::TNet``).

conv(64, 128, 1024) -> global max over points -> dense(512) -> dense(256)
-> ``h @ w + b`` reshaped to (K, K), with ``b`` initialized to the identity.
The current model's convs carry BN + ReLU (the 1024-wide one fused with the
max-pool); the legacy variant (``conv_apply_bn=False``) has neither, and a
zero ``w`` init.

With ``add_regularization`` the training step adds the orthogonality
regularizer :func:`orthogonality_loss` of the transform to its loss (the
JAX package sows it into a ``reg_losses`` collection; here the model hands
the value back to the step).

In ``dtype`` (bf16) the blocks and ``h @ w`` run in it; the transform is
assembled in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_MOMENTUM
from pointcloudprocessing_tpu_torch.models.layers import (
    DenseBlock,
    PointwiseBlock,
    PooledPointwiseBlock,
    glorot_uniform,
)


def orthogonality_loss(transform: torch.Tensor) -> torch.Tensor:
    """``1e-3 * l2_loss(I - X X^T)`` with ``l2_loss(t) = sum(t^2) / 2``,
    summed over the batch as well (``tf.nn.l2_loss``)."""
    k = transform.shape[-1]
    eye = torch.eye(k, dtype=transform.dtype, device=transform.device)
    x_xt = transform @ transform.transpose(-1, -2)
    return 1e-3 * (0.5 * torch.square(eye - x_xt).sum())


class TNet(nn.Module):
    def __init__(
        self,
        k: int,
        add_regularization: bool = False,
        layer_widths: tuple[int, ...] = (64, 128, 1024, 512, 256),
        conv_apply_bn: bool = True,
        conv_activation: Optional[str] = "relu",
        w_init_zeros: bool = False,
        *,
        bn_momentum: float = KERAS_BN_MOMENTUM,
        generator: torch.Generator | None = None,
        device=None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        w = layer_widths
        self.k = k
        self.dtype = dtype
        self.add_regularization = add_regularization
        kw = dict(bn_momentum=bn_momentum, generator=generator, device=device,
                  dtype=dtype)
        self.conv_layer_1 = PointwiseBlock(k, w[0], conv_apply_bn, conv_activation, **kw)
        self.conv_layer_2 = PointwiseBlock(w[0], w[1], conv_apply_bn, conv_activation, **kw)
        self.pooled = conv_apply_bn and conv_activation == "relu"
        if self.pooled:
            self.conv_layer_3 = PooledPointwiseBlock(w[1], w[2], **kw)
        else:
            self.conv_layer_3 = PointwiseBlock(
                w[1], w[2], conv_apply_bn, conv_activation, **kw
            )
        self.dense_layer_1 = DenseBlock(w[2], w[3], apply_bn=True, activation="relu", **kw)
        self.dense_layer_2 = DenseBlock(w[3], w[4], apply_bn=True, activation="relu", **kw)
        if w_init_zeros:
            w_init = torch.zeros((w[4], k * k), device=device)
        else:
            w_init = glorot_uniform((w[4], k * k), w[4], k * k, generator, device)
        self.w = nn.Parameter(w_init)
        self.b = nn.Parameter(torch.eye(k, device=device))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                frozen: bool = False) -> torch.Tensor:
        """x: (b, n, k) -> (b, k, k) transform matrix."""
        flags = dict(train=train, frozen=frozen)
        h = self.conv_layer_1(x, **flags)
        h = self.conv_layer_2(h, **flags)
        h = self.conv_layer_3(h, **flags)
        if not self.pooled:
            h = h.amax(dim=-2)  # symmetric global feature (b, 1024)
        h = self.dense_layer_1(h, **flags)
        h = self.dense_layer_2(h, **flags)
        if self.dtype is None:
            return (h @ self.w).reshape(-1, self.k, self.k) + self.b
        out = h.to(self.dtype) @ self.w.to(self.dtype)
        return out.float().reshape(-1, self.k, self.k) + self.b

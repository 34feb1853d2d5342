"""Building-block layers for the PointNet family
(``pointcloudprocessing_tpu/models/layers.py``).

A 1x1 conv over (b, n, c) points is a per-point dense layer, so every block
is a matmul over the last axis. Conventions of the JAX package (and the
Keras reference) that parity needs: ``use_bias = not apply_bn``, BatchNorm
epsilon 1e-3, Glorot-uniform kernels. Module and parameter names follow the
Flax tree (``conv``/``dense``, ``bn``), so ``convert.py`` maps one onto the
other by name.

BatchNorm is written by hand over the last axis (``nn.BatchNorm1d`` wants
channels at dim 1, and its running variance is the unbiased one) with
Flax's conventions: in train mode a block that is not frozen normalizes by
the batch's mean and biased variance ``E[x^2] - E[x]^2``, clamped at 0,
over every axis but the last, and then updates its running statistics in
place as ``m * old + (1 - m) * batch`` with m = 0.99. A frozen block uses
its running statistics even in train mode and never updates them, as Keras
``trainable=False`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudprocessing_tpu_torch.core.constants import (
    KERAS_BN_EPSILON,
    KERAS_BN_MOMENTUM,
)
from pointcloudprocessing_tpu_torch.models.fused_pool import dense_bn_relu_max


def require_device(device: torch.device | str) -> torch.device:
    """The device a model entry point builds on: ``device`` itself, and a
    clear error, not a silent CPU build, when it is CUDA and CUDA is
    absent. Callers that mean the CPU say ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for (the default of the model "
            "entry points), but CUDA is not available; pass device='cpu' to "
            "build on the CPU"
        )
    return device


def glorot_uniform(
    shape: tuple[int, int],
    fan_in: int,
    fan_out: int,
    generator: torch.Generator | None,
    device: torch.device | str | None,
) -> torch.Tensor:
    """Glorot-uniform tensor drawn on the CPU from ``generator``, then moved."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-limit, limit, generator=generator)
    return t.to(device)


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    raise ValueError(f"Unknown activation: {activation!r}")


class Dense(nn.Module):
    """Dense layer with ``weight`` (out, in) (Flax ``kernel`` transposed)."""

    def __init__(self, in_features: int, features: int, bias: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.weight = nn.Parameter(glorot_uniform(
            (features, in_features), in_features, features, generator, device
        ))
        if bias:
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, Flax's order, with
    the running statistics or (``use_running=False``) the batch's own."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, *, use_running: bool) -> torch.Tensor:
        if use_running:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp(torch.square(x).mean(dim=axes) - torch.square(mean),
                              min=0.0)
            self.update_running(mean, var)
        mul = torch.rsqrt(var + KERAS_BN_EPSILON) * self.weight
        return (x - mean) * mul + self.bias

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = m * running + (1 - m) * batch``, in place."""
        m = KERAS_BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


class PointwiseBlock(nn.Module):
    """Per-point dense + optional BN + activation (the reference's
    ``ConvLayer``). A frozen block uses running statistics even in train
    mode, as Keras ``trainable=False`` does."""

    _dense_name = "conv"

    def __init__(self, in_features: int, features: int, apply_bn: bool = True,
                 activation: Optional[str] = "relu", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.add_module(self._dense_name, Dense(
            in_features, features, bias=not apply_bn, generator=generator,
            device=device,
        ))
        self.bn = BatchNorm(features, device=device) if apply_bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, *, train: bool = False,
                frozen: bool = False) -> torch.Tensor:
        x = getattr(self, self._dense_name)(x)
        if self.bn is not None:
            x = self.bn(x, use_running=(not train) or frozen)
        return apply_activation(x, self.activation)


class DenseBlock(PointwiseBlock):
    """Dense + optional BN + activation (the reference's ``DenseLayer``;
    Flax names its matmul ``dense``)."""

    _dense_name = "dense"

    def __init__(self, in_features: int, features: int, apply_bn: bool = False,
                 activation: Optional[str] = None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(in_features, features, apply_bn, activation,
                         generator=generator, device=device)


class _SplitKernelDense(nn.Module):
    """Dense over a virtual concat [local ++ broadcast(global)] without
    building the concat: ``local @ W[:, :d]^T + global @ W[:, d:]^T``. One
    (features, d_local + d_global) weight, as Dense over the concat would
    hold; the per-point matmul is only d_local wide."""

    def __init__(self, d_local: int, d_global: int, features: int,
                 bias: bool = True, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.d_local = d_local
        d_in = d_local + d_global
        self.weight = nn.Parameter(glorot_uniform(
            (features, d_in), d_in, features, generator, device
        ))
        if bias:
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.register_parameter("bias", None)

    def forward(self, local: torch.Tensor, global_feats: torch.Tensor) -> torch.Tensor:
        per_point = F.linear(local, self.weight[:, : self.d_local])
        per_cloud = F.linear(global_feats, self.weight[:, self.d_local:])
        out = per_point + per_cloud[..., None, :]
        if self.bias is not None:
            out = out + self.bias
        return out


class ConcatPointwiseBlock(nn.Module):
    """PointwiseBlock over [per-point features ++ tiled global vector],
    through :class:`_SplitKernelDense`."""

    def __init__(self, d_local: int, d_global: int, features: int,
                 apply_bn: bool = True, activation: Optional[str] = "relu", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.conv = _SplitKernelDense(
            d_local, d_global, features, bias=not apply_bn,
            generator=generator, device=device,
        )
        self.bn = BatchNorm(features, device=device) if apply_bn else None
        self.activation = activation

    def forward(self, local: torch.Tensor, global_feats: torch.Tensor, *,
                train: bool = False, frozen: bool = False) -> torch.Tensor:
        x = self.conv(local, global_feats)
        if self.bn is not None:
            x = self.bn(x, use_running=(not train) or frozen)
        return apply_activation(x, self.activation)


class PooledPointwiseBlock(nn.Module):
    """``PointwiseBlock(features, BN, relu)`` + global max over points
    (models/fused_pool.py). Same parameters as that block: ``conv.weight``
    and ``bn``."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.conv = Dense(in_features, features, bias=False,
                          generator=generator, device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                frozen: bool = False) -> torch.Tensor:
        bn = self.bn
        use_running = (not train) or frozen
        pooled, mean, var = dense_bn_relu_max(
            x, self.conv.weight, bn.weight, bn.bias, bn.running_mean,
            bn.running_var, KERAS_BN_EPSILON, use_running,
        )
        if not use_running:
            bn.update_running(mean, var)
        return pooled

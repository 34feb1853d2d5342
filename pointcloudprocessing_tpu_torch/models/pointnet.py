"""Multi-head PointNet: classification + per-point segmentation + SE(3)
(``pointcloudprocessing_tpu/models/pointnet.py``).

Input unit-sphere normalization, input T-Net (3x3), shared MLP(64, 64),
feature T-Net (64x64), MLP(64, 128, 1024) with a global max-pool, a
classification head (512 -> dropout -> 256 -> dropout -> softmax) and a
segmentation head on [per-point 64-d ++ global 1024-d] (512 -> 256 -> 128 ->
128 -> softmax). ``vanilla`` drops both T-Nets.

Train mode (``train=True``) normalizes every BatchNorm that ``freeze`` does
not freeze by batch statistics and updates its running statistics in
place, and applies dropout with keep masks drawn from an explicit
``torch.Generator`` (``rand < 1 - rate``, kept values scaled by
``1 / (1 - rate)``, as Flax does). :meth:`PointNet.forward_with_reg` also
returns the T-Net orthogonality regularizers the training step adds to its
loss.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.core.config import TrainableConfig
from pointcloudprocessing_tpu_torch.models.layers import (
    ConcatPointwiseBlock,
    DenseBlock,
    PointwiseBlock,
    PooledPointwiseBlock,
)
from pointcloudprocessing_tpu_torch.models.tnet import TNet, orthogonality_loss
from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere

ALL_HEADS = ("classification_output", "segmentation_output", "se3")


# copied from pointcloudprocessing_tpu/models/pointnet.py::FreezeFlags
@dataclasses.dataclass(frozen=True)
class FreezeFlags:
    """Static per-stage freeze switches: ``shared_network`` covers both
    T-Nets and the shared MLPs, then ``input_transform`` overrides the input
    T-Net."""

    input_transform: bool = False
    shared_network: bool = False
    classification_head: bool = False
    segmentation_head: bool = False


NOTHING_FROZEN = FreezeFlags()


# copied from pointcloudprocessing_tpu/models/pointnet.py::freeze_flags_from_trainable
def freeze_flags_from_trainable(trainable: TrainableConfig) -> FreezeFlags:
    return FreezeFlags(
        input_transform=not trainable.input_transform,
        shared_network=not trainable.shared_network,
        classification_head=not trainable.classification_head,
        segmentation_head=not trainable.segmentation_head,
    )


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout`` in train mode: keep each value with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; rate 0 is the
    identity. The keep mask comes from ``generator`` (``F.dropout`` takes
    none)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError(
            f"dropout at rate {rate} in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# copied from pointcloudprocessing_tpu/models/pointnet.py::layer_trainability
def layer_trainability(freeze: FreezeFlags, vanilla: bool) -> dict[str, bool]:
    """Per-layer trainability report, same names and order as the
    reference's ``PointNet.get_layer_trainability``."""
    report: dict[str, bool] = {"input_normalization": False}
    if not vanilla:
        report["input_transform"] = not freeze.input_transform
    report["s1_l1_64_convolution_layer"] = not freeze.shared_network
    report["s1_l2_64_convolution_layer"] = not freeze.shared_network
    if not vanilla:
        report["feature_transform"] = not freeze.shared_network
    report["s2_l1_64_convolution_layer"] = not freeze.shared_network
    report["s2_l2_128_convolution_layer"] = not freeze.shared_network
    report["s2_l3_1024_convolution_layer"] = not freeze.shared_network
    report["s3_l1_512_dense_layer"] = not freeze.classification_head
    report["s3_l2_256_dense_layer"] = not freeze.classification_head
    report["output_dense_layer"] = not freeze.classification_head
    report["seg_l1_512_convolution_layer"] = not freeze.segmentation_head
    report["seg_l2_256_convolution_layer"] = not freeze.segmentation_head
    report["seg_l3_128_convolution_layer"] = not freeze.segmentation_head
    report["seg_l4_128_convolution_layer"] = not freeze.segmentation_head
    report["seg_l5_output_convolution_layer"] = not freeze.segmentation_head
    return report


class PointNet(nn.Module):
    """The multi-head PointNet; submodule names are the Flax module names.

    Parameters are drawn on the CPU from ``generator`` (Glorot-uniform
    kernels, zero biases, unit BN scales, identity T-Net biases) and placed
    on ``device``.
    """

    def __init__(self, num_classes: int, num_parts: int, vanilla: bool = False,
                 *, dropout_rate: float = 0.3,
                 regularize_input_transform: bool = False,
                 regularize_feature_transform: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.vanilla = vanilla
        self.dropout_rate = dropout_rate
        kw = dict(generator=generator, device=device)
        if not vanilla:
            self.input_transform = TNet(3, regularize_input_transform, **kw)
        self.mlp_1_1 = PointwiseBlock(3, 64, **kw)
        self.mlp_1_2 = PointwiseBlock(64, 64, **kw)
        if not vanilla:
            self.feature_transform = TNet(64, regularize_feature_transform, **kw)
        self.mlp_2_1 = PointwiseBlock(64, 64, **kw)
        self.mlp_2_2 = PointwiseBlock(64, 128, **kw)
        self.mlp_2_3 = PooledPointwiseBlock(128, 1024, **kw)
        self.mlp_cls_1 = DenseBlock(1024, 512, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_2 = DenseBlock(512, 256, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_3 = DenseBlock(256, num_classes, activation="softmax", **kw)
        self.mlp_seg_1 = ConcatPointwiseBlock(64, 1024, 512, **kw)
        self.mlp_seg_2 = PointwiseBlock(512, 256, **kw)
        self.mlp_seg_3 = PointwiseBlock(256, 128, **kw)
        self.mlp_seg_4 = PointwiseBlock(128, 128, **kw)
        self.mlp_seg_5 = PointwiseBlock(
            128, num_parts, apply_bn=False, activation="softmax", **kw
        )

    def forward(
        self,
        points: torch.Tensor,
        *,
        train: bool = False,
        freeze: FreezeFlags = NOTHING_FROZEN,
        generator: torch.Generator | None = None,
        heads: tuple[str, ...] = ALL_HEADS,
    ) -> dict[str, torch.Tensor]:
        """points: (b, n, 3) -> dict of the requested heads' outputs.

        ``heads`` subsets the outputs and the compute: classification-only
        serving skips the segmentation head, ~80% of the FLOPs. ``train``,
        ``freeze`` and ``generator`` (the dropout masks' source) are as in
        :meth:`forward_with_reg`.
        """
        return self.forward_with_reg(points, train=train, freeze=freeze,
                                     generator=generator, heads=heads)[0]

    def forward_with_reg(
        self,
        points: torch.Tensor,
        *,
        train: bool = False,
        freeze: FreezeFlags = NOTHING_FROZEN,
        generator: torch.Generator | None = None,
        heads: tuple[str, ...] = ALL_HEADS,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """The forward pass and the sum of the T-Net regularizers that are
        on (a 0-d tensor, 0 when none is), in train and eval mode alike,
        as Keras adds ``model.losses`` in both."""
        pc, _ = normalize_unit_sphere(points)
        reg = torch.zeros((), dtype=pc.dtype, device=pc.device)
        if not self.vanilla:
            r = self.input_transform(pc, train=train, frozen=freeze.input_transform)
            if self.input_transform.add_regularization:
                reg = reg + orthogonality_loss(r)
            x = pc @ r
        else:
            r = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
                pc.shape[0], 3, 3
            )
            x = pc
        shared = dict(train=train, frozen=freeze.shared_network)
        x = self.mlp_1_1(x, **shared)
        x = self.mlp_1_2(x, **shared)
        if not self.vanilla:
            r64 = self.feature_transform(x, **shared)
            if self.feature_transform.add_regularization:
                reg = reg + orthogonality_loss(r64)
            x_64 = x @ r64
        else:
            x_64 = x
        x = self.mlp_2_1(x_64, **shared)
        x = self.mlp_2_2(x, **shared)
        global_features = self.mlp_2_3(x, **shared)  # (b, 1024)

        outputs: dict[str, torch.Tensor] = {}
        if "se3" in heads:
            outputs["se3"] = r
        if "classification_output" in heads:
            cls = dict(train=train, frozen=freeze.classification_head)
            x_cls = self.mlp_cls_1(global_features, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            x_cls = self.mlp_cls_2(x_cls, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            outputs["classification_output"] = self.mlp_cls_3(x_cls, **cls)
        if "segmentation_output" in heads:
            seg = dict(train=train, frozen=freeze.segmentation_head)
            x_seg = self.mlp_seg_1(x_64, global_features, **seg)
            x_seg = self.mlp_seg_2(x_seg, **seg)
            x_seg = self.mlp_seg_3(x_seg, **seg)
            x_seg = self.mlp_seg_4(x_seg, **seg)
            outputs["segmentation_output"] = self.mlp_seg_5(x_seg, **seg)
        return outputs, reg

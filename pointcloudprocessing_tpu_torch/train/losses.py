"""Losses matching the reference's Keras ``compile()`` configuration
(``pointcloudprocessing_tpu/train/losses.py``).

SparseCategoricalCrossentropy on the classification and segmentation
softmax outputs, MeanSquaredError on the SE(3) head, combined with per-stage
loss weights; the T-Net orthogonality regularizers are added unweighted.
Keras conventions: probabilities are renormalized along the class axis,
then clipped to [1e-7, 1 - 1e-7] before the log; labels are clamped into
range; MSE is a mean per sample, then a mean over the batch.
"""

from __future__ import annotations

import math

import torch

from pointcloudprocessing_tpu_torch.core.constants import KERAS_EPSILON


def sparse_categorical_crossentropy(
    probs: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-element negative log-likelihood from probabilities.

    probs: (..., C) softmax outputs; labels: (...) int. Returns (...) losses.
    """
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = torch.clamp(probs, KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    # an out-of-range label is clamped into range (the JAX package's
    # gather semantics), not silently dropped
    labels = torch.clamp(labels.long(), 0, probs.shape[-1] - 1)
    return -torch.log(probs).gather(-1, labels[..., None]).squeeze(-1)


def mean_squared_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Keras MSE: the mean over every axis but the first, per sample."""
    return torch.square(pred - target).mean(dim=tuple(range(1, pred.dim())))


def multi_head_loss(
    outputs: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    loss_weights: tuple[float, float, float],
    reg_losses_sum: torch.Tensor | float = 0.0,
    batch_size: int | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted multi-head training loss.

    ``loss_weights`` are (classification, segmentation, rotation);
    ``reg_losses_sum`` is added unweighted, as Keras adds ``model.losses``.
    Returns (total, {per-head unweighted losses}) under the Keras history
    names. With ``batch_size`` (a global batch that these rows are a share
    of) each batch mean is this share's sum over ``batch_size`` clouds
    (and their points), so the shares' losses add up to the whole batch's.
    """
    w_cls, w_seg, w_rot = loss_weights

    def mean(t: torch.Tensor) -> torch.Tensor:
        if batch_size is None:
            return t.mean()
        return t.sum() / (batch_size * math.prod(t.shape[1:]))

    cls_loss = mean(sparse_categorical_crossentropy(
        outputs["classification_output"], targets["classification_output"]))
    seg_loss = mean(sparse_categorical_crossentropy(
        outputs["segmentation_output"], targets["segmentation_output"]))
    rot_loss = mean(mean_squared_error(outputs["se3"], targets["se3"]))
    total = w_cls * cls_loss + w_seg * seg_loss + w_rot * rot_loss + reg_losses_sum
    return total, {
        "classification_output_loss": cls_loss,
        "segmentation_output_loss": seg_loss,
        "se3_loss": rot_loss,
    }

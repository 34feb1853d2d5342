"""Single-device train, eval and predict steps with freeze-masked Adam
(``pointcloudprocessing_tpu/train/steps.py``).

- Optimizer: Adam with Keras's epsilon 1e-7 on a continuous exponential
  learning-rate decay, in optax's operation order (``optax.adam`` and
  ``optax.exponential_decay``, non-staircase; the rate is taken at the step
  count before its increment, so the first step uses ``rate``).
- Freeze/thaw: a stage's switches label each top-level submodule "train" or
  "freeze"; frozen parameters get no update and no moment state, and
  frozen BatchNorms use their running statistics inside the model. Frozen
  parameters also take ``requires_grad=False``, so the backward skips
  their gradients (the JAX package computes them and masks the update;
  the updates are the same).
- Randomness: the jitter noise and the dropout masks of step ``s`` come from
  two ``torch.Generator``s seeded from ``(seed, s)``, as the JAX package
  folds the step into its key. The streams differ from JAX's.
- State: the model holds the parameters and the running statistics, and
  the step updates both, and the Adam moments, in place; it returns the
  same state object with ``step`` advanced. After a step each trained
  parameter's ``.grad`` holds that step's gradient; a frozen one's is None.
- Metrics: per-batch correct counts and sums, so a host can rebuild Keras's
  streaming epoch metrics exactly.

The scanned multi-step forms (K steps per dispatch), the shard_map
data-parallel step and bf16 Adam moments are not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping
from functools import partial

import numpy as np
import torch

from pointcloudprocessing_tpu_torch.core.config import LearningConfig
from pointcloudprocessing_tpu_torch.models.pointnet import (
    NOTHING_FROZEN,
    FreezeFlags,
    PointNet,
)
from pointcloudprocessing_tpu_torch.ops.augment import jitter
from pointcloudprocessing_tpu_torch.train.losses import multi_head_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7  # Keras's epsilon


def freeze_label_tree(params: Mapping[str, object], freeze: FreezeFlags) -> dict[str, str]:
    """Label each parameter 'train' or 'freeze' by its top-level submodule,
    per the stage's switches, in the reference's application order
    (``pointnet_train.py:322-332``)."""

    def label_for(name: str) -> str:
        top = name.split(".", 1)[0]
        if top == "input_transform":
            frozen = freeze.input_transform
        elif top == "feature_transform":
            frozen = freeze.shared_network
        elif top.startswith("mlp_cls"):
            frozen = freeze.classification_head
        elif top.startswith("mlp_seg"):
            frozen = freeze.segmentation_head
        else:  # mlp_1_*, mlp_2_*: the shared trunk
            frozen = freeze.shared_network
        return "freeze" if frozen else "train"

    return {name: label_for(name) for name in params}


@dataclasses.dataclass
class AdamState:
    """Adam's step count and first and second moments, for the trained
    parameters only."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class Optimizer:
    """``optax.multi_transform({"train": adam(schedule, eps=1e-7),
    "freeze": set_to_zero()}, labels)`` over named parameters, in f32."""

    def __init__(self, learning: LearningConfig, labels: Mapping[str, str]):
        self.learning = learning
        self.labels = dict(labels)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        trained = [n for n in params if self.labels[n] == "train"]
        zeros = {n: torch.zeros_like(params[n]) for n in trained}
        return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    def learning_rate(self, count: int) -> np.float32:
        """``optax.exponential_decay`` (non-staircase) at ``count``, in f32."""
        rate = np.float32(self.learning.rate)
        if count <= 0:
            return rate
        p = np.float32(count) / np.float32(self.learning.decay_steps)
        return rate * np.power(np.float32(self.learning.decay_rate), p)

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: AdamState) -> None:
        """One Adam step from each trained parameter's ``.grad``, in place:
        ``p - lr * mu_hat / (sqrt(nu_hat) + eps)``, with optax's operations
        in its order. Multi-tensor ``_foreach`` ops update every parameter
        in a dozen launches, where a loop over ~70 tensors took ~1,000 and
        bound the step on the host."""
        lr = float(self.learning_rate(state.count))
        state.count += 1
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(state.count))
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(state.count))
        names = list(state.mu)
        if not names:
            return
        ps = [params[n] for n in names]
        grads = [p.grad for p in ps]
        mus = [state.mu[n] for n in names]
        nus = [state.nu[n] for n in names]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mus, ADAM_B1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - ADAM_B2)
        torch._foreach_mul_(nus, ADAM_B2)
        torch._foreach_add_(nus, sq)
        # p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(ps, upd)


def make_optimizer(learning: LearningConfig, params: Mapping[str, torch.Tensor],
                   freeze: FreezeFlags = NOTHING_FROZEN) -> Optimizer:
    return Optimizer(learning, freeze_label_tree(params, freeze))


@dataclasses.dataclass
class TrainState:
    step: int
    model: PointNet  # parameters and running statistics
    opt_state: AdamState


def init_train_state(
    model: PointNet,
    learning: LearningConfig,
    freeze: FreezeFlags = NOTHING_FROZEN,
) -> tuple[TrainState, Optimizer]:
    """Wrap a built model (its weights seeded or loaded) into a TrainState,
    with ``requires_grad`` on exactly the trained parameters."""
    params = dict(model.named_parameters())
    optimizer = make_optimizer(learning, params, freeze)
    for name, p in params.items():
        p.requires_grad_(optimizer.labels[name] == "train")
    return TrainState(0, model, optimizer.init(params)), optimizer


def step_generators(seed: int, step: int,
                    device: torch.device) -> tuple[torch.Generator, torch.Generator]:
    """(jitter, dropout) generators of one step, seeded from (seed, step)."""
    jitter_seed, dropout_seed = np.random.SeedSequence([seed, step]).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(jitter_seed)),
            torch.Generator(device=device).manual_seed(int(dropout_seed)))


def _metric_sums(outputs, targets) -> dict[str, torch.Tensor]:
    """Per-batch sufficient statistics for Keras streaming metrics."""
    cls_pred = outputs["classification_output"].argmax(dim=-1)
    seg_pred = outputs["segmentation_output"].argmax(dim=-1)
    se3_err = outputs["se3"] - targets["se3"]

    def count(v: int) -> torch.Tensor:
        return torch.tensor(float(v), device=se3_err.device)

    return {
        "classification_correct": (
            cls_pred == targets["classification_output"]).float().sum(),
        "classification_total": count(cls_pred.shape[0]),
        "segmentation_correct": (
            seg_pred == targets["segmentation_output"]).float().sum(),
        "segmentation_total": count(seg_pred.shape[0] * seg_pred.shape[1]),
        "se3_sq_sum": torch.square(se3_err).sum(),
        "se3_count": count(se3_err.numel()),
    }


def _train_step_impl(
    model: PointNet,
    optimizer: Optimizer,
    loss_weights: tuple[float, float, float],
    freeze: FreezeFlags,
    jitter_stdev: tuple[float, float, float],
    state: TrainState,
    x: torch.Tensor,
    targets: dict[str, torch.Tensor],
    seed: int,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    if state.model is not model:
        raise ValueError("the train step was built for another model")
    jitter_g, dropout_g = step_generators(seed, state.step, x.device)
    x = jitter(x, jitter_g, jitter_stdev)
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        outputs, reg = model.forward_with_reg(
            x, train=True, freeze=freeze, generator=dropout_g)
        total, head_losses = multi_head_loss(outputs, targets, loss_weights, reg)
        if total.requires_grad:  # False only when every parameter is frozen
            total.backward()
    optimizer.update_(dict(model.named_parameters()), state.opt_state)
    with torch.no_grad():
        logs = {"loss": total.detach(),
                **{k: v.detach() for k, v in head_losses.items()},
                **_metric_sums(outputs, targets)}
    state.step += 1
    return state, logs


def make_train_step(
    model: PointNet,
    optimizer: Optimizer,
    loss_weights: tuple[float, float, float],
    freeze: FreezeFlags,
    jitter_stdev: tuple[float, float, float],
) -> Callable:
    """The train step: (state, x, targets, seed) -> (state, logs)."""
    return partial(_train_step_impl, model, optimizer, loss_weights, freeze,
                   jitter_stdev)


@torch.no_grad()
def _eval_step_impl(model, loss_weights, jitter_stdev, apply_jitter, state, x,
                    targets, seed):
    if state.model is not model:
        raise ValueError("the eval step was built for another model")
    if apply_jitter:
        x = jitter(x, torch.Generator(device=x.device).manual_seed(seed),
                   jitter_stdev)
    outputs, reg = model.forward_with_reg(x, train=False)
    total, head_losses = multi_head_loss(outputs, targets, loss_weights, reg)
    return {"loss": total, **head_losses, **_metric_sums(outputs, targets)}


def make_eval_step(
    model: PointNet,
    loss_weights: tuple[float, float, float],
    jitter_stdev: tuple[float, float, float] = (0.0, 0.0, 0.0),
    apply_jitter: bool = True,
) -> Callable:
    """The eval step: (state, x, targets, seed) -> logs; mutates nothing.

    Jitter applies to validation too (the reference parses every split
    alike), from a generator seeded with ``seed``: pass a fresh seed per
    batch, or ``apply_jitter=False`` for clean evaluation. The T-Net
    regularizers count in the total, as Keras adds ``model.losses`` in
    ``test_step``.
    """
    return partial(_eval_step_impl, model, loss_weights, jitter_stdev,
                   apply_jitter)


def make_predict_fn(model: PointNet) -> Callable:
    """Inference entry: x -> outputs dict (running statistics, no dropout)."""

    @torch.inference_mode()
    def predict(x: torch.Tensor) -> dict[str, torch.Tensor]:
        return model(x, train=False)

    return predict

"""The PointNet training step, a copy of the semantics of
``pointcloudprocessing_tpu_torch/train/steps.py`` (single device, nothing
frozen), ``train/losses.py`` and ``ops/augment.py::jitter``: per-axis
Gaussian jitter, the train-mode forward, the Keras losses plus the T-Net
regularizers, the backward, and Adam with Keras's epsilon on optax's
exponential decay in optax's order of operations.

Step ``s`` of a run seeded ``seed`` draws its jitter and dropout from two
generators on the points' device, seeded from ``SeedSequence([seed, s])``,
as the program's step does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference import pointnet

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7
KERAS_EPSILON = 1e-7


def step_generators(seed: int, step: int, device) -> tuple[torch.Generator, torch.Generator]:
    jitter_seed, dropout_seed = np.random.SeedSequence([seed, step]).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(jitter_seed)),
            torch.Generator(device=device).manual_seed(int(dropout_seed)))


def crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Keras's sparse categorical crossentropy on probabilities, meaned."""
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = torch.clamp(probs, KERAS_EPSILON, 1.0 - KERAS_EPSILON)
    labels = torch.clamp(labels.long(), 0, probs.shape[-1] - 1)
    return -torch.log(probs).gather(-1, labels[..., None]).squeeze(-1).mean()


def loss_fn(outputs: dict, targets: dict, weights, reg) -> torch.Tensor:
    w_cls, w_seg, w_rot = weights
    cls = crossentropy(outputs["classification_output"], targets["classification_output"])
    seg = crossentropy(outputs["segmentation_output"], targets["segmentation_output"])
    rot = torch.square(outputs["se3"] - targets["se3"]).mean(dim=(1, 2)).mean()
    return w_cls * cls + w_seg * seg + w_rot * rot + reg


@dataclasses.dataclass
class Adam:
    """optax.adam(exponential_decay(rate, decay_steps, decay_rate), eps=1e-7)."""

    rate: float
    decay_steps: int
    decay_rate: float
    count: int = 0
    mu: dict | None = None
    nu: dict | None = None

    def learning_rate(self) -> float:
        rate = np.float32(self.rate)
        if self.count <= 0:
            return float(rate)
        p = np.float32(self.count) / np.float32(self.decay_steps)
        return float(rate * np.power(np.float32(self.decay_rate), p))

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        if self.mu is None:
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        lr = self.learning_rate()
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(self.count))
        for n, p in params.items():
            g = grads[n]
            self.mu[n] = ADAM_B1 * self.mu[n] + (1.0 - ADAM_B1) * g
            self.nu[n] = ADAM_B2 * self.nu[n] + (g * g) * (1.0 - ADAM_B2)
            p += -lr * ((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + ADAM_EPS))


def train_step(params: dict, buffers: dict, adam: Adam, x: torch.Tensor, targets: dict,
               seed: int, step: int, loss_weights, jitter_stdev,
               dropout_rate: float = 0.3, rows: slice = slice(None)
               ) -> tuple[float, dict]:
    """One step on ``params`` (leaf tensors, updated in place); returns the
    loss and the gradients. ``rows`` leaves the rest of the batch out (a
    fault the comparison must catch), after the jitter is drawn."""
    jitter_g, dropout_g = step_generators(seed, step, x.device)
    stdev = torch.tensor(jitter_stdev, dtype=x.dtype, device=x.device)
    noise = torch.randn(x.shape, generator=jitter_g, dtype=torch.float32, device=x.device)
    x = x + noise.to(x.dtype) * stdev
    x, targets = x[rows], {k: v[rows] for k, v in targets.items()}
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad():
        outputs, reg = pointnet.forward({**buffers, **leaves}, x, train=True,
                                        dropout_rate=dropout_rate, generator=dropout_g,
                                        regularize=(True, True))
        loss = loss_fn(outputs, targets, loss_weights, reg)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    adam.update(params, grads)
    return float(loss.detach()), grads

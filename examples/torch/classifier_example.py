"""Legacy classification-only PointNet walkthrough, with the PyTorch port
(twin of ``examples/classifier_example.py``).

The legacy ``PointNetClassifier`` on synthetic shape classes (sphere, cube
and cylinder surfaces), plus a ``TNetRegressor`` rotation pretraining pass.
Adam is ``train/steps.py::adam`` (optax's ``adam`` at a constant rate,
epsilon 1e-7).

Usage: python examples/torch/classifier_example.py [epochs]
[--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.models import (  # noqa: E402
    PointNetClassifier,
    TNetRegressor,
)
from pointcloudprocessing_tpu_torch.ops.augment import random_so3_rotation  # noqa: E402
from pointcloudprocessing_tpu_torch.train import sparse_categorical_crossentropy  # noqa: E402
from pointcloudprocessing_tpu_torch.train.steps import adam  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

N = 128


def make_shapes(batch: int, rng: np.random.Generator, device):
    """Random sphere/cube/cylinder surface clouds and their labels."""
    kinds = rng.integers(0, 3, batch)
    clouds = np.empty((batch, N, 3), np.float32)
    for i, kind in enumerate(kinds):
        if kind == 0:  # sphere
            v = rng.normal(size=(N, 3))
            clouds[i] = v / np.linalg.norm(v, axis=1, keepdims=True)
        elif kind == 1:  # cube surface
            face = rng.integers(0, 3, N)
            sign = rng.choice([-1.0, 1.0], N)
            pts = rng.uniform(-1, 1, (N, 3))
            pts[np.arange(N), face] = sign
            clouds[i] = pts
        else:  # cylinder
            theta = rng.uniform(0, 2 * np.pi, N)
            clouds[i] = np.stack(
                [np.cos(theta), np.sin(theta), rng.uniform(-1, 1, N)], axis=1
            )
    return (torch.from_numpy(clouds).to(device),
            torch.from_numpy(kinds.astype(np.int64)).to(device))


def _step(model, optimizer, state, loss_fn) -> torch.Tensor:
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    optimizer.update_(params, state)
    return loss.detach()


def train_classifier(epochs: int, device="cuda") -> None:
    device = require_device(device)
    rng = np.random.default_rng(0)
    model = PointNetClassifier(3, generator=torch.Generator().manual_seed(0),
                               device=device)
    optimizer = adam(1e-3)
    state = optimizer.init(dict(model.named_parameters()))
    dropout = torch.Generator(device=device).manual_seed(0)
    for epoch in range(epochs):
        x, y = make_shapes(64, rng, device)
        model.train()
        loss = _step(model, optimizer, state, lambda: torch.mean(
            sparse_categorical_crossentropy(model(x, train=True, generator=dropout), y)))
        if (epoch + 1) % max(epochs // 5, 1) == 0:
            vx, vy = make_shapes(64, np.random.default_rng(999), device)
            with torch.no_grad():
                probs = model.eval()(vx)
            acc = float((probs.argmax(-1) == vy).float().mean())
            print(f"epoch {epoch + 1}: loss {float(loss):.3f}  val acc {acc:.2f}")


def pretrain_tnet(epochs: int, device="cuda") -> None:
    """Rotation-regression pretraining of a lone input T-Net."""
    device = require_device(device)
    rng = np.random.default_rng(1)
    model = TNetRegressor(generator=torch.Generator().manual_seed(0),
                          device=device).train()
    base, _ = make_shapes(32, rng, device)
    optimizer = adam(1e-3)
    state = optimizer.init(dict(model.named_parameters()))
    rotations = torch.Generator(device=device).manual_seed(0)
    loss = torch.tensor(float("nan"))
    for _ in range(epochs):
        rots = random_so3_rotation(rotations, (32,), device=device)
        loss = _step(model, optimizer, state, lambda: torch.mean(
            torch.square(model(base @ rots, train=True) - rots.transpose(-1, -2))))
    print(f"T-Net regressor final MSE: {float(loss):.4f}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("epochs", nargs="?", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    print("== PointNetClassifier on synthetic shapes ==")
    train_classifier(args.epochs, args.device)
    print("== TNetRegressor rotation pretraining ==")
    pretrain_tnet(args.epochs, args.device)

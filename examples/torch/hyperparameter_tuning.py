"""Optimizer/learning-rate grid search with LaTeX export, with the PyTorch
port (twin of ``examples/hyperparameter_tuning.py``).

SGD/Adagrad/Adam x {1e-4, 1e-3, 1e-2} through ``run_grid`` on
``--device``, aggregated in a HyperTune table with per-configuration
averages, exported to LaTeX.

Usage: python examples/torch/hyperparameter_tuning.py [epochs]
[--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.train import HyperTune, run_grid  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402


def make_toy_batches(width=64, batch=16, num_classes=4, num_parts=2):
    """Train and val batches: class c shifts x by 3c, the part is z > 0."""
    def batch_of(seed):
        gen = np.random.default_rng(seed)
        x = gen.normal(size=(batch, width, 3)).astype(np.float32)
        cls = gen.integers(0, num_classes, batch).astype(np.int64)
        x[:, :, 0] += cls[:, None] * 3.0
        parts = (x[:, :, 2] > 0).astype(np.int64)
        return x, {
            "classification_output": cls,
            "segmentation_output": parts,
            "se3": np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1)),
        }

    return batch_of(1), batch_of(2)


def main(epochs: int = 3, device="cuda") -> None:
    device = require_device(device)
    train_batch, val_batch = make_toy_batches()
    results = run_grid(
        train_batch, val_batch,
        num_classes=4, num_parts=2, input_width=64,
        epochs=epochs, steps_per_epoch=4, device=device,
    )
    tune = HyperTune("val_classification_output_sparse_categorical_accuracy")
    tune.add_data({"Model": "toy_pointnet", **results})

    print("\n=== per-configuration results ===")
    for config, metrics in tune.get_table()["toy_pointnet"].items():
        print(f"  {config}: {metrics}")
    print("\n=== overview (averaged) ===")
    for config, metrics in tune.get_overview().items():
        print(f"  {config}: {metrics}")
    print("\n=== LaTeX ===")
    print(tune.to_latex())


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("epochs", nargs="?", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.epochs, args.device)

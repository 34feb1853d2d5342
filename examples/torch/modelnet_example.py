"""Public-dataset sanity workload: PointNet classification on ModelNet10,
with the PyTorch port (twin of ``examples/modelnet_example.py``).

Samples point clouds from a ModelNet-layout directory of ``.off`` meshes
that the user gives, trains the classifier on ``--device`` and reports
train and test accuracy. Nothing is downloaded: without a dataset path (or
with one that does not exist) the script falls back to the procedural
shape library, so the workflow runs in a clean environment.

Usage:
  python examples/torch/modelnet_example.py [/path/to/ModelNet10] [epochs]
  [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.synthesis import MeshSampler, shape_library  # noqa: E402
from pointcloudprocessing_tpu_torch.synthesis.mesh import load_off  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

NUM_POINTS = 1024
CLOUDS_PER_CLASS = {"train": 32, "test": 8}


def modelnet_meshes(root: str, split: str, per_class: int):
    """Yield (class_name, Mesh) from a ModelNet10/40-layout directory
    (<root>/<class>/<split>/<class>_NNNN.off)."""
    for class_dir in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(class_dir):
            continue
        class_name = os.path.basename(class_dir)
        for path in sorted(
            glob.glob(os.path.join(class_dir, split, "*.off"))
        )[:per_class]:
            yield class_name, load_off(path)


def build_arrays(pairs, num_points: int, seed: int = 0,
                 label_map: dict | None = None, device="cuda"):
    """Sample one fixed-size cloud per mesh; returns (x, y, class names).

    ``label_map`` fixes the class-name -> label assignment (the test split
    must reuse the train split's map, or a class missing from one split
    shifts every later label)."""
    clouds, labels = [], []
    names = {} if label_map is None else dict(label_map)
    frozen = label_map is not None
    for i, (class_name, mesh) in enumerate(pairs):
        if frozen:
            if class_name not in names:
                print(
                    f"Skipping a '{class_name}' mesh: the class has no "
                    "training meshes, so it has no label"
                )
                continue
            label = names[class_name]
        else:
            label = names.setdefault(class_name, len(names))
        # distinct sampling per mesh instance (repeated meshes in the
        # procedural fallback must still yield distinct clouds)
        sampler = MeshSampler(None, class_name, mesh=mesh, random_seed=seed + i,
                              device=device)
        obs, _, _, _ = sampler.create_full_sample_observations(
            n=1, p=num_points, pad=num_points
        )
        clouds.append(obs[0])
        labels.append(label)
    x = np.asarray(clouds, np.float32)
    y = np.asarray(labels, np.int64)
    return x, y, names


def fallback_pairs(split: str):
    lib = shape_library(4)
    n = CLOUDS_PER_CLASS[split]
    for name, mesh in lib.items():
        for _ in range(n):
            yield name, mesh


def main(root: str | None, epochs: int = 20, device="cuda") -> float:
    import torch

    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.models import FreezeFlags, PointNet
    from pointcloudprocessing_tpu_torch.train import (
        init_train_state,
        make_train_step,
    )

    device = require_device(device)
    if root and os.path.isdir(root):
        print(f"Loading ModelNet meshes from {root}")
        train_pairs = modelnet_meshes(root, "train", CLOUDS_PER_CLASS["train"])
        test_pairs = modelnet_meshes(root, "test", CLOUDS_PER_CLASS["test"])
    else:
        print("No dataset directory found - using the procedural shape library")
        train_pairs = fallback_pairs("train")
        test_pairs = fallback_pairs("test")

    x_train, y_train, label_map = build_arrays(train_pairs, NUM_POINTS, seed=0,
                                               device=device)
    x_test, y_test, _ = build_arrays(
        test_pairs, NUM_POINTS, seed=1, label_map=label_map, device=device
    )
    classes = sorted(label_map, key=label_map.get)
    print(f"{len(classes)} classes, {len(y_train)} train / {len(y_test)} test clouds")

    model = PointNet(len(classes), 1, vanilla=True,
                     generator=torch.Generator().manual_seed(0), device=device)
    freeze = FreezeFlags(segmentation_head=True)
    state, optimizer = init_train_state(model, LearningConfig(rate=1e-3), freeze)
    step = make_train_step(model, optimizer, (1.0, 0.0, 0.0), freeze, (0.0, 0.0, 0.0))

    batch = 16
    rng = np.random.default_rng(0)
    dummy_parts = torch.zeros((batch, NUM_POINTS), dtype=torch.long, device=device)
    dummy_se3 = torch.eye(3, device=device).expand(batch, 3, 3).contiguous()
    for epoch in range(epochs):
        model.train()
        order = rng.permutation(len(y_train))
        correct = total = 0.0
        for start in range(0, len(order) - batch + 1, batch):
            idx = order[start : start + batch]
            targets = {
                "classification_output": torch.from_numpy(y_train[idx]).to(device),
                "segmentation_output": dummy_parts,
                "se3": dummy_se3,
            }
            state, logs = step(state, torch.from_numpy(x_train[idx]).to(device),
                               targets, epoch)
            correct += float(logs["classification_correct"])
            total += float(logs["classification_total"])
        print(f"epoch {epoch + 1}/{epochs} train acc {correct / max(total, 1):.3f}")

    model.eval()
    with torch.no_grad():
        outputs = model(torch.from_numpy(x_test).to(device))
    pred = outputs["classification_output"].argmax(-1).cpu().numpy()
    acc = float((pred == y_test).mean())
    print(f"test accuracy: {acc:.3f} over {len(classes)} classes")
    return acc


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=None)
    parser.add_argument("epochs", nargs="?", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.root, args.epochs, args.device)

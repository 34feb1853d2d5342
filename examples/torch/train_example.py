"""End-to-end training example with the PyTorch port: mesh -> synthetic
observations -> staged training -> export -> reload check (twin of
``examples/train_example.py``).

The reference notebook's workflow (data synthesis, segmentation training,
model reload, export, re-inference) on ``--device``. The trainer writes
the stage's ``{name}_{stage}.pt2`` program at the stage's end; this script
reloads it with ``export/pt2.py::load_program`` (where the JAX script
loads its ``.stablehlo``) and classifies fresh observations with it.

Usage: python examples/torch/train_example.py [work_dir] [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.core.config import parse_config  # noqa: E402
from pointcloudprocessing_tpu_torch.data import PointCloudSet  # noqa: E402
from pointcloudprocessing_tpu_torch.export import load_program  # noqa: E402
from pointcloudprocessing_tpu_torch.synthesis import MeshSampler  # noqa: E402
from pointcloudprocessing_tpu_torch.train import TrainProfile  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

CUBE_OBJ = """v -1 -1 -1\nv 1 -1 -1\nv 1 1 -1\nv -1 1 -1\nv -1 -1 1\nv 1 -1 1\nv 1 1 1\nv -1 1 1\nf 1 4 3 2\nf 5 6 7 8\nf 1 2 6 5\nf 2 3 7 6\nf 3 4 8 7\nf 4 1 5 8\n"""

WIDTH = 128


def main(work_dir: str = "train_example_out", device="cuda", width: int = WIDTH,
         epochs: int = 8, frames: int = 40) -> float:
    """Returns the reloaded program's agreement on small-cube frames."""
    import torch

    device = require_device(device)
    os.makedirs(work_dir, exist_ok=True)
    for sub in ("models", "data", "input"):
        os.makedirs(os.path.join(work_dir, sub), exist_ok=True)

    # 1. synthesize viewpoint observations from a mesh
    mesh_path = os.path.join(work_dir, "cube.obj")
    with open(mesh_path, "w") as f:
        f.write(CUBE_OBJ)

    class_labels = ["cube", "big-cube"]
    part_labels = ["surface"]

    # name must be {config name}_{stage name} so TrainProfile reuses it
    pc = PointCloudSet(
        name="example_final", class_labels=class_labels, part_labels=part_labels,
        network_input_width=width, batch_size=8, rand_seed=42,
        data_path=os.path.join(work_dir, "data") + "/",
    )
    for cls_idx, (label, scale) in enumerate([("cube", 1.0), ("big-cube", 3.0)]):
        sampler = MeshSampler(mesh_path, label, scale=scale, random_seed=cls_idx,
                              device=device)
        obs, _, pos, dcms = sampler.create_viewpoint_observations(
            n=frames, p=2000, pad=width, dist_range=(6.0, 12.0)
        )
        pc.add_data(
            f"{label}_collect",
            obs.astype(np.float32),
            np.full(len(obs), cls_idx, np.int64),
            np.zeros((len(obs), width), np.int64),
            dcms.astype(np.float32),
        )

    # 2. staged training via the reference config schema
    config = {
        "info": {
            "name": "example",
            "class_labels": {str(i): c for i, c in enumerate(class_labels)},
            "part_labels": {str(i): p for i, p in enumerate(part_labels)},
            "training_profiles": {
                "final": {
                    "datasets": {},  # data pre-ingested above
                    "noise": {"x_stdev_m": 0.02, "y_stdev_m": 0.02, "z_stdev_m": 0.02},
                    "trainable": {"shared_network": True, "input_transform": True,
                                  "classification_head": True, "segmentation_head": True},
                    "loss_weights": {"classification": 1.0, "segmentation": 0.2,
                                     "rotation": 0.0},
                    "monitor": "val_classification_output_loss",
                }
            },
            "continue_training_model": "",
        },
        "params": {
            "input_width": width, "epochs": epochs, "patience": 10, "batch_size": 8,
            "learning": {"rate": 1e-3, "decay_steps": 500, "decay_rate": 0.9},
            "random_seed": 42, "debugging": False, "vanilla": True,
            "regularize_input_transform": False, "regularize_feature_transform": False,
        },
        "file_system": {
            "model_path": os.path.join(work_dir, "models") + "/",
            "input_path": os.path.join(work_dir, "input") + "/",
            "data_path": os.path.join(work_dir, "data") + "/",
        },
    }
    tp = TrainProfile(parse_config(config), log_to_file=False, device=device)
    histories = tp.train()
    acc = histories["final"]["val_classification_output_sparse_categorical_accuracy"]
    print(f"final val classification accuracy: {acc[-1]:.3f}")

    # 3. reload the exported program and check that it still classifies
    artifact = os.path.join(work_dir, "models", "example", "final", "example_final.pt2")
    program = load_program(artifact).module()
    sampler = MeshSampler(mesh_path, "cube", scale=1.0, random_seed=99, device=device)
    obs, _, _, _ = sampler.create_viewpoint_observations(n=8, p=2000, pad=width)
    with torch.no_grad():
        cls, seg, se3 = program(torch.from_numpy(obs.astype(np.float32)).to(device))
    agreement = float((cls.argmax(-1) == 0).float().mean())
    print(f"exported-artifact small-cube agreement: {agreement:.2f}")
    return agreement


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("work_dir", nargs="?", default="train_example_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.work_dir, args.device)

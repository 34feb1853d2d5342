"""Summarize training histories and evaluate a checkpoint on a test split,
with the PyTorch port (twin of ``examples/evaluate.py``).

Training-curve summaries per stage (best epoch, best val accuracy/loss)
plus a model.evaluate-style pass of a PointNet stage's ``best/model.pt``
over a set's test split on ``--device``.

Usage: python examples/torch/evaluate.py <model_dir> [<data_dir>/<set_name>]
[--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.toolkit.training_history import (  # noqa: E402
    load_training_history,
)


def summarize(model_dir: str) -> None:
    history = load_training_history(model_dir)
    if not history:
        print(f"No *_history.json found under {model_dir}")
        return
    print(f"== {model_dir} ==")
    for key in sorted(history):
        series = np.asarray(history[key], dtype=float)
        if "loss" in key:
            best_epoch = int(series.argmin()) + 1
            print(f"  {key}: min {series.min():.4f} @ epoch {best_epoch}")
        elif "accuracy" in key:
            best_epoch = int(series.argmax()) + 1
            print(f"  {key}: max {series.max():.4f} @ epoch {best_epoch}")


def evaluate_checkpoint(model_dir: str, set_dir: str, device="cuda") -> dict:
    """The test split's loss and accuracies under the stage's checkpoint;
    returns the eval step's logs (empty for an empty split)."""
    import torch

    from pointcloudprocessing_tpu_torch.data import load_from_file
    from pointcloudprocessing_tpu_torch.models import PointNet
    from pointcloudprocessing_tpu_torch.train import (
        TrainState,
        load_checkpoint,
        make_eval_step,
    )
    from pointcloudprocessing_tpu_torch.utils.device import require_device

    device = require_device(device)
    pc = load_from_file(os.path.join(set_dir, "pc_set.joblib"))
    arrays = pc.load_split_arrays("test")
    if arrays["observations"].shape[0] == 0:
        print("Test split is empty.")
        return {}

    payload = load_checkpoint(model_dir, device)
    num_classes = payload["mlp_cls_3.dense.weight"].shape[0]
    num_parts = payload["mlp_seg_5.conv.weight"].shape[0]
    vanilla = not any(k.startswith("input_transform.") for k in payload)
    model = PointNet(num_classes, num_parts, vanilla=vanilla, device=device)
    model.load_state_dict(payload)
    model.eval()

    state = TrainState(step=0, model=model, opt_state=None)
    eval_step = make_eval_step(model, (1.0, 1.0, 1.0), apply_jitter=False)

    def tensor(key, dtype):
        return torch.from_numpy(np.asarray(arrays[key])).to(device, dtype)

    logs = eval_step(
        state,
        tensor("observations", torch.float32),
        {
            "classification_output": tensor("class_label", torch.long),
            "segmentation_output": tensor("part_labels", torch.long),
            "se3": tensor("se3", torch.float32),
        },
        0,
    )
    print(f"test loss: {float(logs['loss']):.4f}")
    print(
        "test classification accuracy: "
        f"{float(logs['classification_correct']) / float(logs['classification_total']):.4f}"
    )
    print(
        "test segmentation accuracy: "
        f"{float(logs['segmentation_correct']) / float(logs['segmentation_total']):.4f}"
    )
    return logs


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model_dir")
    parser.add_argument("set_dir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    summarize(args.model_dir)
    if args.set_dir:
        evaluate_checkpoint(args.model_dir, args.set_dir, args.device)

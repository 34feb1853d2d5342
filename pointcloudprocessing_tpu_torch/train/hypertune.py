"""Hyperparameter grid search over optimizers and learning rates
(``pointcloudprocessing_tpu/train/hypertune.py``).

``run_grid`` trains a PointNet for each (optimizer, rate) cell through the
port's train and eval steps, every cell from the same seeded weights;
``HyperTune`` aggregates the histories (the best validation score and the
lowest validation loss of each cell, per-configuration averages across
models, a LaTeX table).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from pointcloudprocessing_tpu_torch.core.config import LearningConfig, TrainConfig
from pointcloudprocessing_tpu_torch.models.factory import model_from_config
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags
from pointcloudprocessing_tpu_torch.train import steps as steps_lib

OPTIMIZERS: dict[str, Callable] = {
    "SGD": steps_lib.sgd,
    "Adagrad": steps_lib.adagrad,
    "Adam": steps_lib.adam,
}
LEARNING_RATES = (1e-4, 1e-3, 1e-2)


# copied from pointcloudprocessing_tpu/train/hypertune.py::HyperTune
class HyperTune:
    """Aggregates per-model grid results (notebook cell 1 semantics)."""

    def __init__(self, val_score_key: str):
        self._val_score_key = val_score_key
        self._rows: list[dict] = []

    def add_data(self, history: dict) -> None:
        """history: {'Model': name, '<Opt> <lr>': history-dict, ...}."""
        row: dict = {}
        for key, value in history.items():
            if key == "Model":
                row["Model"] = value
            else:
                row[key] = {
                    self._val_score_key: max(value[self._val_score_key]),
                    "val_loss": min(value["val_loss"]),
                }
        self._rows.append(row)

    def get_table(self) -> dict:
        """{model: {config: {score, val_loss}}}."""
        return {
            row["Model"]: {k: v for k, v in row.items() if k != "Model"}
            for row in self._rows
        }

    def get_overview(self) -> dict:
        """Average score/val_loss per configuration across models."""
        sums: dict[str, dict] = defaultdict(lambda: {"score": 0.0, "val_loss": 0.0})
        for row in self._rows:
            for key, value in row.items():
                if key == "Model":
                    continue
                sums[key]["score"] += value[self._val_score_key]
                sums[key]["val_loss"] += value["val_loss"]
        n = max(len(self._rows), 1)
        return {
            k: {self._val_score_key: v["score"] / n, "val_loss": v["val_loss"] / n}
            for k, v in sums.items()
        }

    def to_latex(self) -> str:
        """LaTeX table of the overview (notebook exports via df.to_latex)."""
        overview = self.get_overview()
        lines = [
            "\\begin{tabular}{lrr}",
            "\\toprule",
            f"Configuration & {self._val_score_key.replace('_', ' ')} & val loss \\\\",
            "\\midrule",
        ]
        for config, vals in overview.items():
            lines.append(
                f"{config} & {vals[self._val_score_key]:.4f} & {vals['val_loss']:.4f} \\\\"
            )
        lines += ["\\bottomrule", "\\end{tabular}"]
        return "\n".join(lines)


def _on_device(batch, device: torch.device):
    x, targets = batch
    return (torch.as_tensor(x, device=device),
            {k: torch.as_tensor(v, device=device) for k, v in targets.items()})


def run_grid(
    train_batch,
    val_batch,
    num_classes: int,
    num_parts: int,
    input_width: int,
    epochs: int = 5,
    steps_per_epoch: int = 8,
    optimizers: dict[str, Callable] | None = None,
    learning_rates=LEARNING_RATES,
    vanilla: bool = True,
    seed: int = 42,
    print_func=print,
    device="cuda",
) -> dict[str, dict]:
    """Train the grid on in-memory batches; returns {'<Opt> <lr>': history}.

    ``train_batch`` / ``val_batch``: (x, targets) tuples (targets keyed by
    the heads' names), numpy arrays or tensors, moved to ``device`` (CUDA
    unless the caller asks for the CPU). Each cell builds its model from a
    generator seeded with ``seed``, so every cell starts from the same
    weights; nothing is frozen, and the cell's optimizer updates every
    parameter. History keys are the notebook's: loss, val_loss, the two
    validation accuracies and val_root_mean_squared_error.
    """
    optimizers = optimizers if optimizers is not None else OPTIMIZERS
    cfg = TrainConfig(
        name="hypertune", class_labels=tuple(map(str, range(num_classes))),
        part_labels=tuple(map(str, range(num_parts))), stages=(),
        input_width=input_width, vanilla=vanilla,
    )
    freeze = FreezeFlags()
    x, targets = _on_device(train_batch, torch.device(device))
    vx, vtargets = _on_device(val_batch, torch.device(device))
    results: dict[str, dict] = {}
    for opt_name, opt_fn in optimizers.items():
        for lr in learning_rates:
            label = f"{opt_name} {lr}"
            print_func(f"HyperTune: training {label}")
            model = model_from_config(
                cfg, training=True, generator=torch.Generator().manual_seed(seed),
                device=device)
            state, _ = steps_lib.init_train_state(model, LearningConfig(rate=lr), freeze)
            optimizer = opt_fn(lr)
            state.opt_state = optimizer.init(dict(model.named_parameters()))
            train_step = steps_lib.make_train_step(
                model, optimizer, (1.0, 1.0, 0.0), freeze, (0.0, 0.0, 0.0))
            eval_step = steps_lib.make_eval_step(model, (1.0, 1.0, 0.0),
                                                 apply_jitter=False)
            history = defaultdict(list)
            for _ in range(epochs):
                logs = None
                for _ in range(steps_per_epoch):
                    state, logs = train_step(state, x, targets, seed)
                vlogs = {k: np.float32(v.item())
                         for k, v in eval_step(state, vx, vtargets, seed).items()}
                history["loss"].append(float(logs["loss"]))
                history["val_loss"].append(float(vlogs["loss"]))
                history["val_classification_output_sparse_categorical_accuracy"].append(
                    float(vlogs["classification_correct"])
                    / float(vlogs["classification_total"]))
                history["val_segmentation_output_sparse_categorical_accuracy"].append(
                    float(vlogs["segmentation_correct"])
                    / float(vlogs["segmentation_total"]))
                history["val_root_mean_squared_error"].append(
                    float(np.sqrt(vlogs["se3_sq_sum"] / vlogs["se3_count"])))
            results[label] = dict(history)
    return results

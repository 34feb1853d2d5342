"""Training-history loading (``pointcloudprocessing_tpu/toolkit/training_history.py``;
the headless logic of gui/TrainingPerformance.py:57-97).

Glob ``*_history.json`` under a model directory tree and merge the metric
series; the GUI plots 'accuracy'/'error' metrics on y1 and 'loss' metrics on
y2 — ``split_axes`` reproduces that partition for any plotting frontend.
"""

from __future__ import annotations

import glob
import json
import os


# copied from pointcloudprocessing_tpu/toolkit/training_history.py::load_training_history
def load_training_history(model_dir: str) -> dict[str, list]:
    """Merge every ``*_history.json`` under ``model_dir`` (recursive)."""
    history: dict[str, list] = {}
    pattern = os.path.join(model_dir, "**", "*_history.json")
    for path in sorted(glob.glob(pattern, recursive=True)):
        with open(path, "r") as f:
            data = json.load(f)
        for key, series in data.items():
            history.setdefault(key, []).extend(series)
    return history


# copied from pointcloudprocessing_tpu/toolkit/training_history.py::split_axes
def split_axes(history: dict[str, list]) -> tuple[dict, dict]:
    """(y1 accuracy/error metrics, y2 loss metrics) — the dual-axis split
    the reference GUI uses (gui/TrainingPerformance.py:40-55)."""
    y1 = {
        k: v
        for k, v in history.items()
        if "accuracy" in k or "error" in k
    }
    y2 = {k: v for k, v in history.items() if "loss" in k}
    return y1, y2

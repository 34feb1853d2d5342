"""Fixed-width resampling of ragged frames on the host (numpy only)."""

from __future__ import annotations

import numpy as np


# copied from pointcloudprocessing_tpu/ops/resample.py::adjust_to_input_width_np
def adjust_to_input_width_np(
    observations: np.ndarray,
    part_labels: np.ndarray,
    width: int,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side resample of one frame to ``width`` points: truncate to the
    first ``width`` points, or pad with a uniform repeat-sample of existing
    points drawn as ``rng.uniform(0, n)`` (the reference's draw), labels
    kept aligned.

    Returns (observations (width, 3), part_labels (width,)).
    """
    n = observations.shape[0]
    if n > width:
        return observations[:width], part_labels[:width]
    if n == width:
        return observations, part_labels

    gen = rng if rng is not None else np.random.default_rng()
    repeated = gen.uniform(0, n, width - n).astype(np.int_)
    observations = np.concatenate([observations, observations[repeated]], axis=0)
    part_labels = np.concatenate([part_labels, part_labels[repeated]], axis=0)
    return observations, part_labels

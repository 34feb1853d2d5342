"""Fixed-width resampling of ragged frames
(``pointcloudprocessing_tpu/ops/resample.py``): on the host in numpy
(:func:`adjust_to_input_width_np`, the ingest path), and on the device over
fixed-shape buffers with a valid count (:func:`adjust_to_input_width`,
:func:`adjust_batch_to_input_width`).

The device form draws its repeat uniforms from a ``torch.Generator``
apart from the index rule (:func:`resample_indices`), so the rule can be
held against the JAX package's on the uniforms its keys draw.
"""

from __future__ import annotations

import numpy as np
import torch


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


def resample_indices(uniforms: torch.Tensor, valid_count: torch.Tensor,
                     max_n: int) -> torch.Tensor:
    """Row indices (..., width) of a fixed-width resample: row i keeps row i
    while i < valid_count, past it takes ``int(u_i * valid_count)``, and
    every index is clipped to [0, max_n - 1]. ``uniforms`` is (..., width)
    and ``valid_count`` (...,) ints."""
    width = uniforms.shape[-1]
    count = torch.as_tensor(valid_count, device=uniforms.device)[..., None]
    idx = torch.arange(width, device=uniforms.device)
    repeat = (uniforms * count.to(torch.float32)).to(torch.int32)
    gather = torch.where(idx < count, idx.to(torch.int32), repeat)
    return torch.clamp(gather, 0, max_n - 1).long()


def adjust_to_input_width(
    points: torch.Tensor,
    labels: torch.Tensor,
    valid_count,
    width: int,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side fixed-shape resample of one frame: ``points`` (max_n, 3)
    with ``valid_count`` valid rows at the front and aligned ``labels``
    (max_n,) -> (points (width, 3), labels (width,)). With
    ``valid_count >= width`` it is the first ``width`` rows; otherwise rows
    [valid_count, width) are uniform repeats of the valid prefix, drawn
    from ``generator`` (on the points' device). Rows past ``valid_count``
    are never selected."""
    u = torch.rand((width,), generator=generator, device=points.device)
    gather = resample_indices(u, valid_count, points.shape[0])
    return points[gather], labels[gather]


def adjust_batch_to_input_width(
    points: torch.Tensor,
    labels: torch.Tensor,
    valid_counts,
    width: int,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`adjust_to_input_width` over a batch: points (b, max_n, 3),
    labels (b, max_n), valid_counts (b,) -> (b, width, 3), (b, width), as
    one batched gather."""
    b, max_n = labels.shape
    u = torch.rand((b, width), generator=generator, device=points.device)
    gather = resample_indices(u, valid_counts, max_n)
    return (torch.gather(points, 1, gather[..., None].expand(b, width, points.shape[-1])),
            torch.gather(labels, 1, gather))

"""Batched row gathers (``pointcloudprocessing_tpu/ops/gather.py::gather_rows``).

The JAX package selects rows on the TPU as one-hot matrix-unit products
with a bf16 hi/lo split, because a TPU row gather is latency-bound; that
is a TPU device and is not ported. Here a gather is ``torch.gather``,
exact in every dtype.
"""

from __future__ import annotations

import torch


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, n, c), idx (b, ...) int -> (b, ..., c): ``out[b, ..., :] =
    x[b, idx[b, ...], :]``."""
    b, c = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1).long()
    rows = x.gather(1, flat[..., None].expand(-1, -1, c))
    return rows.reshape(*idx.shape, c)

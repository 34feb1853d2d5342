"""Self-kNN graphs of point clouds in feature space: the hand-written CUDA
kernel and its plain version.

DGCNN's ``models/dgcnn.py::knn_graph`` asks, for each point of each cloud,
for the k points of the same cloud (itself included) nearest in a feature
space of c channels. No TPU kernel does this: the JAX package leaves the
(b, n, n) distances and their selection to XLA. The plain version here
builds those distances as the expansion ``|q|^2 + |p|^2 - 2 q.p`` (an f32
product, TF32 off) and runs ``torch.topk``; the kernel
(``csrc/knn_select.cu``) computes the same expansion a tile at a time in
shared memory and keeps each row's running top-k in registers, so no (b,
n, n) tensor is written (``csrc/knn_select.cu`` says why and how).

:func:`knn_select` is the route: a CUDA tensor goes to the kernel, and any
failure raises (k past ``MAX_K`` too); a CPU tensor takes the plain
version.
"""

from __future__ import annotations

import torch

from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.knn import pairwise_sq_dists

#: the largest k the kernel's register lists hold (32 entries a register)
MAX_K = 256


def knn_select_reference(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: exact ``topk`` on the clamped expanded distance
    ``|q|^2 + |p|^2 - 2 q.p`` in f32 with TF32 off (the expansion cancels;
    see ``ops/knn.py``). feats (b, n, c) -> (b, n, k) int32, ascending by
    distance."""
    f = feats.float()
    return torch.topk(-pairwise_sq_dists(f, f), k, dim=-1).indices.int()


def list_width(k: int) -> int:
    """Registers a lane of the kernel holds of each row's running list: the
    least of 1, 2, 4 and 8 whose 32 entries a register hold k. A k past
    ``MAX_K`` raises."""
    for width in (1, 2, 4, 8):
        if k <= 32 * width:
            return width
    raise ValueError(f"the kNN kernel takes k <= {MAX_K}, got k {k}")


def knn_select(feats: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest points of every point within its own cloud, self
    included: feats (b, n, c) f32 contiguous -> (b, n, k) int32, ascending
    by the expanded distance, equal distances on the lower index (so the
    members are distinct). A CUDA tensor takes the kernel (k up to
    ``MAX_K``), a CPU tensor the plain version (any k, its ``topk``
    breaking ties its own way). No host sync."""
    if feats.dim() != 3:
        raise ValueError(f"need feats (b, n, c), got {tuple(feats.shape)}")
    if feats.dtype != torch.float32:
        raise TypeError(f"the kNN kernel takes f32 features, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("the kNN kernel needs contiguous features")
    b, n, c = feats.shape
    if not 1 <= k <= n or c < 1:
        raise ValueError(f"a kNN graph takes 1 <= k <= n and c >= 1, got k {k} at n {n}, "
                         f"c {c}")
    if feats.device.type == "cpu":
        return knn_select_reference(feats, k)
    if feats.device.type != "cuda":
        raise ValueError(f"no kNN kernel for device {feats.device}")
    width = list_width(k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=feats.device)
    build.launch("pcp_knn_select", feats.device, feats.data_ptr(),
                 out.data_ptr(), b, n, c, k, width)
    build.count("knn_select")
    return out

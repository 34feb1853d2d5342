"""DGCNN, the dynamic-graph EdgeConv family
(``pointcloudprocessing_tpu/models/dgcnn.py``).

Four EdgeConv layers (64, 64, 128, 256) with the kNN graph rebuilt in each
layer's feature space (``graph='dynamic'``) or built once on the normalized
input (``graph='static'``), their concatenation lifted to 1024 by a shared
pointwise embedding and max-pooled, then a classification head (512 ->
256 -> softmax, dropout between) and a segmentation head on [per-point 512
++ global 1024] (256 -> 256 -> 128 -> softmax). The head contract is
PointNet's; ``se3`` is the identity (the family regresses no rotation).

An EdgeConv's edge MLP has two implementations over one parameter tree
(``ecN.l1.conv.weight``, ``ecN.l1.bn``):

- ``reference``: the literal dataflow, ``PointwiseBlock`` over the (b, n,
  k, 2c) edge tensor [x_i ++ (x_j - x_i)], then the max over k;
- ``factored``: ``W [x_i ++ (x_j - x_i)] = p_i + q_j`` with p = x (U - V)
  and q = x V. With fixed BatchNorm statistics (inference, or a frozen
  trunk) the max over k is attained at the neighbours' max or min of q per
  channel, which the ``gather_maxmin`` kernel computes with no (b, n, k, w)
  tensor; with batch statistics (training) the neighbour rows are gathered
  and normalized over (b, n, k).

``impl='auto'`` takes ``factored`` for a CUDA tensor and ``reference`` for
a CPU one, as the JAX package takes ``factored`` on its accelerator. kNN is
exact (``torch.topk``) in f32 with TF32 off; the JAX package's approximate
TPU search is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.models.layers import (
    ConcatPointwiseBlock,
    DenseBlock,
    PointwiseBlock,
    require_device,
)
from pointcloudprocessing_tpu_torch.models.pointnet import (
    ALL_HEADS,
    NOTHING_FROZEN,
    FreezeFlags,
    dropout,
)
from pointcloudprocessing_tpu_torch.ops.cuda.gather_maxmin import gather_maxmin
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows
from pointcloudprocessing_tpu_torch.ops.knn import full_f32_matmul
from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere

EDGE_IMPLS = ("auto", "reference", "factored")
GRAPHS = ("dynamic", "static")


def knn_graph(feats: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest neighbours of every point within its own cloud, self
    included: (b, n, c) -> (b, n, k) int32. Exact ``topk`` on the clamped
    expanded distance ``|q|^2 + |p|^2 - 2 q.p`` in f32 with TF32 off (the
    expansion cancels; see ``ops/knn.py``)."""
    f = feats.float()
    sq = (f * f).sum(dim=-1)
    with full_f32_matmul():
        cross = torch.matmul(f, f.transpose(1, 2))
    d = torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * cross, min=0.0)
    return torch.topk(-d, k, dim=-1).indices.int()


def edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Edge tensor [x_i ++ (x_j - x_i)] of a kNN graph: x (b, n, c), idx
    (b, n, k) -> (b, n, k, 2c)."""
    nbr = gather_rows(x, idx)
    center = x[:, :, None, :].expand_as(nbr)
    return torch.cat([center, nbr - center], dim=-1)


class EdgeConv(nn.Module):
    """One EdgeConv: kNN graph, edge MLP (a ``PointwiseBlock`` named ``l1``
    over 2c inputs, BN and relu, no bias), max over the neighbours."""

    def __init__(self, in_features: int, features: int, k: int,
                 impl: str = "auto", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if impl not in EDGE_IMPLS:
            # a typo like 'factoredd' must not silently run the slow
            # literal dataflow and mask a perf regression
            raise ValueError(
                f"edge impl must be 'auto', 'reference', or 'factored'; "
                f"got {impl!r}")
        self.k = k
        self.impl = impl
        self.l1 = PointwiseBlock(2 * in_features, features,
                                 generator=generator, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                frozen: bool = False, idx: torch.Tensor | None = None
                ) -> torch.Tensor:
        impl = self.impl
        if impl == "auto":
            impl = "factored" if x.device.type == "cuda" else "reference"
        if idx is None:
            idx = knn_graph(x, self.k)
        if impl == "reference":
            h = self.l1(edge_features(x, idx), train=train, frozen=frozen)
            return h.amax(dim=2)
        return self._factored(x, idx, train=train, frozen=frozen)

    def _factored(self, x, idx, *, train: bool, frozen: bool) -> torch.Tensor:
        c = x.shape[-1]
        weight = self.l1.conv.weight  # (w, 2c): [U ++ V] transposed
        u, v = weight[:, :c], weight[:, c:]
        p = torch.nn.functional.linear(x, u - v)  # (b, n, w)
        q = torch.nn.functional.linear(x, v)
        bn = self.l1.bn
        if train and not frozen:
            g = gather_rows(q, idx)  # (b, n, k, w)
            h = bn(p[:, :, None, :] + g, use_running=False)
            return torch.relu(h).amax(dim=2)
        qmax, qmin = gather_maxmin(q.contiguous(), idx.contiguous())
        return torch.maximum(torch.relu(bn(p + qmax, use_running=True)),
                             torch.relu(bn(p + qmin, use_running=True)))


# copied from pointcloudprocessing_tpu/models/dgcnn.py::layer_trainability_dgcnn
def layer_trainability_dgcnn(freeze: FreezeFlags) -> dict[str, bool]:
    """Per-layer trainability report for the training log (the DGCNN
    analogue of ``layer_trainability``; DGCNN has no transforms)."""
    report: dict[str, bool] = {"input_normalization": False}
    for name in ("ec1_edgeconv", "ec2_edgeconv", "ec3_edgeconv",
                 "ec4_edgeconv", "emb_aggregation"):
        report[name] = not freeze.shared_network
    for name in ("mlp_cls_1_512", "mlp_cls_2_256", "mlp_cls_out"):
        report[name] = not freeze.classification_head
    for name in ("mlp_seg_1_256", "mlp_seg_2_256", "mlp_seg_3_128",
                 "mlp_seg_out"):
        report[name] = not freeze.segmentation_head
    return report


class DGCNN(nn.Module):
    """Multi-head DGCNN; submodule names are the Flax module names.

    Parameters are drawn on the CPU from ``generator`` (Glorot-uniform
    kernels, zero biases, unit BN scales) and placed on ``device``. Train
    mode normalizes by batch statistics and updates the running ones, and
    draws the dropout masks from ``forward``'s generator, as
    :class:`PointNet` does.
    """

    def __init__(self, num_classes: int, num_parts: int, k: int = 20,
                 edge_widths: tuple[int, ...] = (64, 64, 128, 256),
                 emb_width: int = 1024, dropout_rate: float = 0.3,
                 edge_impl: str = "auto", graph: str = "dynamic", *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if graph not in GRAPHS:
            raise ValueError(
                f"graph must be 'dynamic' or 'static'; got {graph!r}")
        self.k = k
        self.graph = graph
        self.dropout_rate = dropout_rate
        self.edge_widths = tuple(edge_widths)
        kw = dict(generator=generator, device=device)
        c = 3
        for i, width in enumerate(self.edge_widths):
            self.add_module(f"ec{i + 1}", EdgeConv(c, width, k, edge_impl, **kw))
            c = width
        local = sum(self.edge_widths)
        self.emb = PointwiseBlock(local, emb_width, **kw)
        self.mlp_cls_1 = DenseBlock(emb_width, 512, apply_bn=True,
                                    activation="relu", **kw)
        self.mlp_cls_2 = DenseBlock(512, 256, apply_bn=True, activation="relu",
                                    **kw)
        self.mlp_cls_out = DenseBlock(256, num_classes, activation="softmax",
                                      **kw)
        self.mlp_seg_1 = ConcatPointwiseBlock(local, emb_width, 256, **kw)
        self.mlp_seg_2 = PointwiseBlock(256, 256, **kw)
        self.mlp_seg_3 = PointwiseBlock(256, 128, **kw)
        self.mlp_seg_out = PointwiseBlock(128, num_parts, apply_bn=False,
                                          activation="softmax", **kw)

    def forward(
        self,
        points: torch.Tensor,
        *,
        train: bool = False,
        freeze: FreezeFlags = NOTHING_FROZEN,
        generator: torch.Generator | None = None,
        heads: tuple[str, ...] = ALL_HEADS,
    ) -> dict[str, torch.Tensor]:
        """points: (b, n, 3) -> dict of the requested heads' outputs."""
        pc, _ = normalize_unit_sphere(points)
        frozen_trunk = freeze.shared_network
        # static graph: one input-space kNN shared by every EdgeConv
        shared_idx = knn_graph(pc, self.k) if self.graph == "static" else None
        x, layer_outs = pc, []
        for i in range(len(self.edge_widths)):
            x = getattr(self, f"ec{i + 1}")(x, train=train, frozen=frozen_trunk,
                                            idx=shared_idx)
            layer_outs.append(x)
        local = torch.cat(layer_outs, dim=-1)  # (b, n, sum(widths))
        emb = self.emb(local, train=train, frozen=frozen_trunk)
        global_features = emb.amax(dim=1)  # (b, emb_width)

        outputs: dict[str, torch.Tensor] = {}
        if "se3" in heads:
            outputs["se3"] = torch.eye(3, dtype=points.dtype,
                                       device=points.device).expand(
                points.shape[0], 3, 3)
        if "classification_output" in heads:
            cls = dict(train=train, frozen=freeze.classification_head)
            x_cls = self.mlp_cls_1(global_features, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            x_cls = self.mlp_cls_2(x_cls, **cls)
            if train:
                x_cls = dropout(x_cls, self.dropout_rate, generator)
            outputs["classification_output"] = self.mlp_cls_out(x_cls, **cls)
        if "segmentation_output" in heads:
            seg = dict(train=train, frozen=freeze.segmentation_head)
            d = self.mlp_seg_1(local, global_features, **seg)
            d = self.mlp_seg_2(d, **seg)
            d = self.mlp_seg_3(d, **seg)
            outputs["segmentation_output"] = self.mlp_seg_out(d, **seg)
        return outputs


def dgcnn_for_width(num_classes: int, num_parts: int, input_width: int,
                    k: int | None = None, *, device="cuda", **kwargs) -> DGCNN:
    """DGCNN with the graph size clamped for small clouds: k (20 unless
    given) never exceeds ``input_width``. Builds on ``device``, CUDA unless
    the caller asks for the CPU; without CUDA the default raises."""
    return DGCNN(
        num_classes, num_parts,
        k=max(min(20 if k is None else int(k), input_width), 1),
        device=require_device(device), **kwargs,
    )

"""Point Transformer (Zhao, Jiang, Jia, Torr and Koltun, ICCV 2021,
arXiv:2012.09164): vector self-attention over each point's k nearest
neighbours, in the five-stage U-Net of the authors' segmentation network
(``pointtransformer_seg_repro``), with the multi-head contract of the other
families.

Stage s = 1..5 holds ``n_s = N / 4^(s-1)`` points (1,024, 256, 64, 16 and 4
at N = 1,024) of width 32, 64, 128, 256 and 512, and a neighbourhood of
``k_s = min(K_s, n_s)`` points, K = (8, 16, 16, 16, 16):

- stage 1 enters by ``relu(BN(W p))``; stage s >= 2 by a transition down:
  FPS to n_s centroids, the min(K_s, n_{s-1}) nearest points of the previous
  stage to each, the grouped [p_j - p_i ++ x_j] through a dense layer, BN
  and relu, and the max over the group;
- each stage's kNN graph G_s (self included) is built once, by
  :func:`knn_graph` on the stage's coordinates, and reused by every encoder
  and decoder block of the stage: the coordinates do not change within a
  stage, so this is an exact rewrite of the release's search in every layer;
- a block is ``relu(BN3(W3 relu(BN2(A(relu(BN1(W1 x)))))) + x)``, 1, 2, 3, 5
  and 2 of them a stage in the encoder and one a stage in the decoder;
- the vector attention A over G with C channels and s = 8 weight shares:
  q, k and v projections; the position encoding delta_ij, an MLP 3 -> 3 -> C
  on p_j - p_i; the relation r_ij = k_j - q_i + delta_ij through a weight
  MLP (BN, relu, C -> C/8, BN, relu, C/8 -> C/8); a softmax over the
  neighbours for each of the C/8 channels; the sum over the neighbours of
  the weights times v_j + delta_ij, weight channel t shared by the value
  channels u C/8 + t, u = 0..7;
- the decoder enters stage 5 by ``relu(BN(W_a [x_i ++ relu(W_b mean(x) +
  b)]))`` and stage s <= 4 by ``relu(BN(W1 x_enc)) + interp(relu(BN(W2
  x_dec)))``, the 3-NN interpolation weighted by inverse Euclidean distance;
- segmentation: relu(BN) 32 -> 32, then softmax over the parts; classification:
  the mean of the encoder's stage-5 features, 256 and 128 with BN, relu and
  dropout, then softmax over the classes (Pointcept's ``PointTransformerCls``);
  ``se3`` is the identity.

Every dense layer directly before a BatchNorm drops its bias, which the
BatchNorm's shift absorbs, as ``PointwiseBlock`` does, and BatchNorm takes
the port's epsilon of 1e-3. In inference the forward first folds the
blocks' BatchNorms into affines ``x s + t`` (:func:`fold_batchnorms`, a
few launches for all of them) and each into the dense layer before it,
``(W s, t)``: a dense + BN + relu is then a matmul with a bias and a relu,
where the BatchNorm alone took six launches, three of them passes over the
matmul's output. The same function within f32 rounding, at 60% of the
launches a forward, so the host's issue of a batch stays well inside the
card's time for it. Self-graphs go through DGCNN's
``knn_graph`` (the ``knn_select`` kernel on CUDA), the transitions' searches
through PointNet++'s ``_grouping_knn`` and ``_three_nearest``, FPS through
``ops/fps.py``. The rest is plain PyTorch in f32; bf16 is refused.

Inside a profiler session the model opens ``pcp.model.knn`` around every
neighbour search (the five self-graphs, the four transition-down kNNs and
the four 3-NN searches), ``pcp.model.attn`` around each of the 18 calls of
A, ``pcp.model.down`` around each transition down and ``pcp.model.up``
around each transition up (``utils/profiling.span``); a search's span nests
inside its transition's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudprocessing_tpu_torch.core.constants import KERAS_BN_EPSILON
from pointcloudprocessing_tpu_torch.models.dgcnn import knn_graph
from pointcloudprocessing_tpu_torch.models.layers import (
    BatchNorm,
    ConcatPointwiseBlock,
    Dense,
    DenseBlock,
    PointwiseBlock,
    apply_activation,
)
from pointcloudprocessing_tpu_torch.models.pointnet import (
    ALL_HEADS,
    NOTHING_FROZEN,
    FreezeFlags,
    dropout,
)
from pointcloudprocessing_tpu_torch.models.pointnet2 import _grouping_knn, _three_nearest
from pointcloudprocessing_tpu_torch.ops.fps import farthest_point_sample_batch
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows
from pointcloudprocessing_tpu_torch.ops.normalize import normalize_unit_sphere
from pointcloudprocessing_tpu_torch.utils.device import require_device
from pointcloudprocessing_tpu_torch.utils.profiling import span

WIDTHS = (32, 64, 128, 256, 512)
STRIDES = (1, 4, 4, 4, 4)
NSAMPLE = (8, 16, 16, 16, 16)
ENCODER_BLOCKS = (1, 2, 3, 5, 2)
SHARE_PLANES = 8


def stage_sizes(input_width: int) -> list[tuple[int, int, int]]:
    """(points n_s, self-graph k_s, transition-down group) of each stage for
    clouds of ``input_width`` points: n_s the width over the strides so far
    (at least 1), k_s = min(K_s, n_s), the group min(K_s, n_{s-1}) (0 for
    stage 1, which has no transition down)."""
    out, n_prev, n = [], None, input_width
    for stride, k in zip(STRIDES, NSAMPLE):
        n = max(n // stride, 1)
        out.append((n, min(k, n), 0 if n_prev is None else min(k, n_prev)))
        n_prev = n
    return out


class _NormRelu(nn.Module):
    """``relu(BN(x))``, the BatchNorm held as ``bn``; with ``fold`` (an
    inference forward's :func:`fold_batchnorms`) ``relu(x s + t)``."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.bn = BatchNorm(features, device=device)

    def forward(self, x, *, train: bool = False, frozen: bool = False, fold=None):
        if fold is not None:
            scale, shift = fold[self]
            return torch.relu(torch.addcmul(shift, x, scale))
        return torch.relu(self.bn(x, use_running=(not train) or frozen))


class _Pointwise(PointwiseBlock):
    """A ``PointwiseBlock`` with BatchNorm; with ``fold`` its dense layer
    runs on the folded kernel and shift ``(W s, t)``."""

    def forward(self, x, *, train: bool = False, frozen: bool = False, fold=None):
        if fold is None:
            return super().forward(x, train=train, frozen=frozen)
        weight, shift = fold[self]
        return apply_activation(F.linear(x, weight, shift), self.activation)


def fold_batchnorms(owners: list[nn.Module]
                    ) -> dict[nn.Module, tuple[torch.Tensor, torch.Tensor]]:
    """The inference BatchNorm of each of ``owners`` (:class:`_Pointwise`
    and :class:`_NormRelu`) as ``x s + t``, s = rsqrt(var + eps) gamma and
    t = beta - mean s, computed once over the statistics of all of them
    concatenated: ``{owner: (W s[:, None], t)}`` for a ``_Pointwise``,
    ``{owner: (s, t)}`` for a ``_NormRelu``."""
    bns = [owner.bn for owner in owners]

    def joined(name):
        return torch.cat([getattr(bn, name) for bn in bns])

    scale = torch.rsqrt(joined("running_var") + KERAS_BN_EPSILON) * joined("weight")
    shift = joined("bias") - joined("running_mean") * scale
    sizes = [bn.weight.numel() for bn in bns]
    return {owner: (owner.conv.weight * s[:, None], t) if isinstance(owner, _Pointwise)
            else (s, t)
            for owner, s, t in zip(owners, scale.split(sizes), shift.split(sizes))}


class VectorAttention(nn.Module):
    """Point Transformer's layer A over a kNN graph: ``q``, ``k``, ``v``
    (dense with bias), the position encoding ``pos1`` (3 -> 3, BN, relu)
    and ``pos2`` (3 -> C, bias), the weight MLP ``rel`` (BN, relu), ``w1``
    (C -> C/s, BN, relu) and ``w2`` (C/s -> C/s, bias), s = ``SHARE_PLANES``."""

    def __init__(self, features: int, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        share = SHARE_PLANES
        if features % share:
            raise ValueError(f"{features} channels do not split into {share} shares")
        kw = dict(generator=generator, device=device)
        self.share = share
        self.q = Dense(features, features, **kw)
        self.k = Dense(features, features, **kw)
        self.v = Dense(features, features, **kw)
        self.pos1 = _Pointwise(3, 3, **kw)
        self.pos2 = Dense(3, features, **kw)
        self.rel = _NormRelu(features, device=device)
        self.w1 = _Pointwise(features, features // share, **kw)
        self.w2 = Dense(features // share, features // share, **kw)

    def forward(self, p: torch.Tensor, y: torch.Tensor, idx: torch.Tensor, *,
                train: bool = False, frozen: bool = False, fold=None) -> torch.Tensor:
        """p (b, n, 3), y (b, n, C), idx (b, n, k) -> (b, n, C)."""
        bn = dict(train=train, frozen=frozen, fold=fold)
        b, n, c = y.shape
        q, key, value = self.q(y), self.k(y), self.v(y)
        delta = self.pos2(self.pos1(gather_rows(p, idx) - p[:, :, None, :], **bn))
        r = gather_rows(key, idx) - q[:, :, None, :] + delta  # (b, n, k, C)
        weights = torch.softmax(self.w2(self.w1(self.rel(r, **bn), **bn)), dim=2)
        vals = (gather_rows(value, idx) + delta).view(b, n, -1, self.share, c // self.share)
        return (vals * weights[:, :, :, None, :]).sum(dim=2).reshape(b, n, c)


class PointTransformerBlock(nn.Module):
    """``relu(BN3(W3 relu(BN2(A(relu(BN1(W1 x)))))) + x)``: ``l1``, ``attn``,
    ``norm2``, ``l3``; A inside the span ``pcp.model.attn``."""

    def __init__(self, features: int, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.l1 = _Pointwise(features, features, **kw)
        self.attn = VectorAttention(features, **kw)
        self.norm2 = _NormRelu(features, device=device)
        self.l3 = _Pointwise(features, features, activation=None, **kw)

    def forward(self, p, x, idx, *, train: bool = False, frozen: bool = False, fold=None):
        bn = dict(train=train, frozen=frozen, fold=fold)
        y = self.l1(x, **bn)
        with span("pcp.model.attn"):
            z = self.attn(p, y, idx, **bn)
        return torch.relu(self.l3(self.norm2(z, **bn), **bn) + x)


class TransitionDown(nn.Module):
    """FPS to ``points`` centroids, the ``group`` nearest points of the
    previous stage to each, [p_j - p_i ++ x_j] through ``l1`` (dense, BN,
    relu), the max over the group; inside ``pcp.model.down``, its kNN
    inside ``pcp.model.knn``."""

    def __init__(self, in_features: int, features: int, points: int, group: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.points, self.group = points, group
        self.l1 = _Pointwise(3 + in_features, features, generator=generator, device=device)

    def forward(self, p, x, *, train: bool = False, frozen: bool = False, fold=None):
        with span("pcp.model.down"):
            new_p = gather_rows(p, farthest_point_sample_batch(p, self.points))
            with span("pcp.model.knn"):
                idx, _ = _grouping_knn(new_p, p, self.group)
            grouped = torch.cat([gather_rows(p, idx) - new_p[:, :, None, :],
                                 gather_rows(x, idx)], dim=-1)
            return new_p, self.l1(grouped, train=train, frozen=frozen, fold=fold).amax(dim=2)


def interpolate(fine: torch.Tensor, coarse: torch.Tensor, feats: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """3-NN interpolation from the coarse points' features to the fine
    points, weights ``1 / (d + eps)`` normalized, d the Euclidean distance;
    the search inside ``pcp.model.knn``. fine (b, n, 3), coarse (b, m, 3),
    feats (b, m, c) -> (b, n, c)."""
    with span("pcp.model.knn"):
        idx, sq = _three_nearest(fine, coarse)
    w = 1.0 / (torch.sqrt(sq) + eps)
    w = w / w.sum(dim=-1, keepdim=True)
    return (gather_rows(feats, idx) * w[..., None]).sum(dim=2)


class TransitionUp(nn.Module):
    """``relu(BN(W1 x_enc)) + interp(relu(BN(W2 x_dec)))`` (``l1``, ``l2``),
    inside ``pcp.model.up``."""

    def __init__(self, features: int, coarse_features: int, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.l1 = _Pointwise(features, features, **kw)
        self.l2 = _Pointwise(coarse_features, features, **kw)

    def forward(self, p, x, coarse_p, coarse_x, *, train: bool = False,
                frozen: bool = False, fold=None):
        bn = dict(train=train, frozen=frozen, fold=fold)
        with span("pcp.model.up"):
            return self.l1(x, **bn) + interpolate(p, coarse_p, self.l2(coarse_x, **bn))


class HeadTransition(nn.Module):
    """The decoder's entry at stage 5: ``relu(BN(W_a [x_i ++ relu(W_b
    mean(x) + b)]))`` (``l1`` over the concat without building it,
    ``glob``), inside ``pcp.model.up``; its BatchNorm is not folded, and
    ``fold`` is taken with the decoder's other arguments and not used."""

    def __init__(self, features: int, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.glob = DenseBlock(features, features, activation="relu", **kw)
        self.l1 = ConcatPointwiseBlock(features, features, features, **kw)

    def forward(self, x, *, train: bool = False, frozen: bool = False, fold=None):
        with span("pcp.model.up"):
            return self.l1(x, self.glob(x.mean(dim=1)), train=train, frozen=frozen)


def layer_trainability_point_transformer(freeze: FreezeFlags) -> dict[str, bool]:
    """Per-layer trainability report for the training log (the Point
    Transformer analogue of ``layer_trainability``): the encoder is the
    shared network, the decoder belongs to the segmentation head."""
    report: dict[str, bool] = {"input_normalization": False}
    report["stage1_entry"] = not freeze.shared_network
    for s in range(1, len(WIDTHS) + 1):
        if s > 1:
            report[f"stage{s}_transition_down"] = not freeze.shared_network
        report[f"stage{s}_encoder_blocks"] = not freeze.shared_network
    for name in ("mlp_cls_1_256", "mlp_cls_2_128", "mlp_cls_out"):
        report[name] = not freeze.classification_head
    for s in range(len(WIDTHS), 0, -1):
        report[f"stage{s}_transition_up"] = not freeze.segmentation_head
        report[f"stage{s}_decoder_block"] = not freeze.segmentation_head
    for name in ("mlp_seg_1_32", "mlp_seg_out"):
        report[name] = not freeze.segmentation_head
    return report


class PointTransformer(nn.Module):
    """Multi-head Point Transformer. The encoder, the shared network:
    ``stem``, ``down2``..``down5``, ``enc1``..``enc5`` (lists of blocks); the
    classification head ``mlp_cls_1``, ``mlp_cls_2``, ``mlp_cls_out``; the
    decoder and segmentation head ``mlp_seg_up5``..``mlp_seg_up1``,
    ``mlp_seg_dec5``..``mlp_seg_dec1``, ``mlp_seg_1``, ``mlp_seg_out`` (the
    prefixes by which ``train/steps.py::freeze_label_tree`` labels them).

    Parameters are drawn on the CPU from ``generator`` (Glorot-uniform
    kernels, zero biases, unit BN scales) and placed on ``device``. Train
    mode normalizes by batch statistics and updates the running ones, and
    draws the classification head's dropout masks from ``forward``'s
    generator, as :class:`PointNet` does. f32 only: ``dtype`` other than
    None or f32 raises.
    """

    def __init__(self, num_classes: int, num_parts: int, input_width: int = 1024,
                 dropout_rate: float = 0.5, *,
                 generator: torch.Generator | None = None, device=None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if dtype not in (None, torch.float32):
            raise ValueError(f"Point Transformer computes in f32 only, got dtype {dtype}")
        self.widths, self.strides, self.nsample = WIDTHS, STRIDES, NSAMPLE
        self.encoder_blocks, self.share_planes = ENCODER_BLOCKS, SHARE_PLANES
        self.dropout_rate = dropout_rate
        self.sizes = stage_sizes(input_width)
        kw = dict(generator=generator, device=device)
        self.stem = _Pointwise(3, WIDTHS[0], **kw)
        for s, (c, (n, _, group), blocks) in enumerate(
                zip(WIDTHS, self.sizes, ENCODER_BLOCKS), start=1):
            if s > 1:
                self.add_module(f"down{s}", TransitionDown(WIDTHS[s - 2], c, n, group, **kw))
            self.add_module(f"enc{s}", nn.ModuleList(
                PointTransformerBlock(c, **kw) for _ in range(blocks)))
        last = len(WIDTHS)
        for s in range(last, 0, -1):
            self.add_module(f"mlp_seg_up{s}", HeadTransition(WIDTHS[-1], **kw) if s == last
                            else TransitionUp(WIDTHS[s - 1], WIDTHS[s], **kw))
            self.add_module(f"mlp_seg_dec{s}", PointTransformerBlock(WIDTHS[s - 1], **kw))
        self.mlp_cls_1 = DenseBlock(WIDTHS[-1], 256, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_2 = DenseBlock(256, 128, apply_bn=True, activation="relu", **kw)
        self.mlp_cls_out = DenseBlock(128, num_classes, activation="softmax", **kw)
        self.mlp_seg_1 = _Pointwise(WIDTHS[0], WIDTHS[0], **kw)
        self.mlp_seg_out = PointwiseBlock(WIDTHS[0], num_parts, apply_bn=False,
                                      activation="softmax", **kw)
        # the blocks whose BatchNorms an inference forward folds
        self.foldable = [m for m in self.modules() if isinstance(m, (_Pointwise, _NormRelu))]

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
        fold = None if train else fold_batchnorms(self.foldable)
        enc = dict(train=train, frozen=freeze.shared_network, fold=fold)
        p, x = pc, self.stem(pc, **enc)
        stages = []  # (points, encoder features, graph) a stage
        for s, (_, k, _) in enumerate(self.sizes, start=1):
            if s > 1:
                p, x = getattr(self, f"down{s}")(p, x, **enc)
            idx = knn_graph(p, k).long()  # int64 once, for the stage's gathers
            for block in getattr(self, f"enc{s}"):
                x = block(p, x, idx, **enc)
            stages.append((p, x, idx))

        outputs: dict[str, torch.Tensor] = {}
        if "se3" in heads:
            outputs["se3"] = torch.eye(3, dtype=points.dtype,
                                       device=points.device).expand(points.shape[0], 3, 3)
        if "classification_output" in heads:
            cls = dict(train=train, frozen=freeze.classification_head)
            h = self.mlp_cls_1(stages[-1][1].mean(dim=1), **cls)
            if train:
                h = dropout(h, self.dropout_rate, generator)
            h = self.mlp_cls_2(h, **cls)
            if train:
                h = dropout(h, self.dropout_rate, generator)
            outputs["classification_output"] = self.mlp_cls_out(h, **cls)
        if "segmentation_output" in heads:
            seg = dict(train=train, frozen=freeze.segmentation_head, fold=fold)
            last = len(stages)
            p, x, idx = stages[-1]
            d = getattr(self, f"mlp_seg_up{last}")(x, **seg)
            d = getattr(self, f"mlp_seg_dec{last}")(p, d, idx, **seg)
            for s in range(last - 1, 0, -1):
                coarse_p = p
                p, x, idx = stages[s - 1]
                d = getattr(self, f"mlp_seg_up{s}")(p, x, coarse_p, d, **seg)
                d = getattr(self, f"mlp_seg_dec{s}")(p, d, idx, **seg)
            out = self.mlp_seg_out(self.mlp_seg_1(d, **seg), train=train,
                                   frozen=freeze.segmentation_head)
            outputs["segmentation_output"] = out
        return outputs


def point_transformer_for_width(num_classes: int, num_parts: int, input_width: int, *,
                                device="cuda", **kwargs) -> PointTransformer:
    """Point Transformer at the release's widths for clouds of
    ``input_width`` points (stage sizes by :func:`stage_sizes`). Builds on
    ``device``, CUDA unless the caller asks for the CPU; without CUDA the
    default raises."""
    return PointTransformer(num_classes, num_parts, input_width,
                            device=require_device(device), **kwargs)

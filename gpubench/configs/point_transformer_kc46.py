"""``point_transformer_kc46``: the port's
``models/point_transformer.py::point_transformer_for_width(23, 12, 1024)``,
the release's segmentation network (widths 32-512, strides 1, 4, 4, 4, 4,
neighbourhoods 8 and 16, 1, 2, 3, 5 and 2 blocks a stage) with the
multi-head heads, in f32, and its twin in the reference.

The file beside this one (``point_transformer_kc46.json``) holds the sizes as
run.

The network makes discrete choices on coordinates: each stage's kNN graph.
The program builds it with the ``knn_select`` kernel's f32 expansion, the
reference from exact float64 distances, and a near-tie that rounding breaks
one way in one and the other way in the other swaps a neighbour and moves
the heads. So the reference replays the program on the same points, records
its five graphs, and takes the program's set in a row only where that set is
a near-tie of its own exact one, k distinct points within tau of it
(``reference/dgcnn.py::take_ties``).
"""

from __future__ import annotations

import sys

import torch

from gpubench.reference import point_transformer as reference

#: tau's constant, in units of ``2^-23 (|x_i|^2 + max_j |x_j|^2)``: a row takes
#: the program's set where the farthest of it lies at most this far past the
#: reference's own k-th distance. The program's graphs are built on the
#: normalized coordinates themselves (c = 3, |x| <= 1), so the only rounding
#: is that of the kernel's f32 expansion ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j``, a
#: few units: sound runs on the H100 took at most 2.02 (PERF.md). A graph
#: built from the coordinates rounded to bf16 lies far past it (1% of its
#: differing rows within 16.3 units, half within ~1,120), so tau takes ~1% of
#: such rows and a run on such graphs is not correct. The DGCNN cell's
#: constant.
TIE_SCALE = 16.0


def stage_sizes(cfg: dict, width: int | None = None) -> list[tuple[int, int, int]]:
    """(points, self-graph k, transition-down group) of each stage at
    ``width`` input points (the configuration's by default): the points
    over the strides so far, k = min(nsample, points), the group
    min(nsample, the previous stage's points), 0 at stage 1."""
    out, prev, n = [], None, cfg["input_width"] if width is None else width
    for stride, k in zip(cfg["strides"], cfg["nsample"]):
        n = max(n // stride, 1)
        out.append((n, min(k, n), 0 if prev is None else min(k, prev)))
        prev = n
    return out


def build_program(cfg: dict, device, train: bool = False):
    """The port's model on ``device``, through the family's constructor
    (the release's sizes are the family's constants); its widths, strides,
    neighbourhoods, block counts and stage sizes must be the
    configuration's."""
    from pointcloudprocessing_tpu_torch.models.point_transformer import (
        point_transformer_for_width,
    )

    model = point_transformer_for_width(cfg["num_classes"], cfg["num_parts"],
                                        cfg["input_width"], dropout_rate=cfg["dropout_rate"],
                                        device=device)
    stages = len(model.widths)
    built = (list(model.widths), list(model.strides), list(model.nsample),
             [len(getattr(model, f"enc{s}")) for s in range(1, stages + 1)],
             [1 for s in range(1, stages + 1) if hasattr(model, f"mlp_seg_dec{s}")],
             model.share_planes, [list(s) for s in model.sizes])
    stated = (cfg["widths"], cfg["strides"], cfg["nsample"], cfg["encoder_blocks"],
              cfg["decoder_blocks"], cfg["share_planes"], [list(s) for s in stage_sizes(cfg)])
    if built != stated:
        raise ValueError(f"the program's (widths, strides, nsample, encoder blocks, decoder "
                         f"blocks, share, stage sizes) are {built}, the configuration's "
                         f"{stated}")
    return model.train(train)


def replay(program, points: torch.Tensor) -> list[torch.Tensor]:
    """The kNN graphs that the program's eval forward on ``points`` builds,
    one a stage in order, recorded by a stand-in for
    ``models.point_transformer.knn_graph`` for the call only."""
    from pointcloudprocessing_tpu_torch.models import point_transformer as program_pt

    real, graphs = program_pt.knn_graph, []

    def recording(feats, k):
        idx = real(feats, k)
        graphs.append(idx)
        return idx

    program_pt.knn_graph = recording
    try:
        with torch.inference_mode():
            program(points)
    finally:
        program_pt.knn_graph = real
    return graphs


def reference_forward(cfg: dict, weights: dict):
    """The reference's eval forward over ``weights``: points -> heads. Each
    call replays the program (built once, from the same ``weights``) on the
    same points, takes its tie-breaks within tau (``TIE_SCALE``) and writes
    to standard error what it took."""
    program = None

    def forward(points):
        nonlocal program
        if program is None:
            program = build_program(cfg, points.device)
            program.load_state_dict(weights)
        graphs = replay(program, points.contiguous())
        heads, ties = reference.forward(weights, points, stage_sizes(cfg, points.shape[1]),
                                        cfg["encoder_blocks"], cfg["share_planes"],
                                        dropout_rate=cfg["dropout_rate"],
                                        program_graphs=graphs, scale=TIE_SCALE)
        print("point transformer reference: the program's set taken in "
              + ", ".join(f"{t.taken} of {t.differ}" for t in ties)
              + " differing rows by stage, over its layers; largest excess taken "
              + ", ".join(f"{t.largest_taken:.3g}" for t in ties)
              + "; largest excess of the differing rows "
              + ", ".join(f"{t.largest_differ:.3g}" for t in ties)
              + f" (tau's constant {TIE_SCALE:g})", file=sys.stderr)
        return heads
    return forward


def model_fps(cfg: dict, width: int) -> list[tuple[int, int]]:
    """FPS calls inside the model a cloud, (points, picks): one a transition
    down."""
    sizes = stage_sizes(cfg, width)
    return [(a[0], b[0]) for a, b in zip(sizes, sizes[1:])]


def attn_layers(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(stage, points, k, channels) of each call of the vector attention in
    a forward, encoder then decoder: 18 at the published depth."""
    sizes = stage_sizes(cfg)
    enc = [(s + 1, n, k, c) for s, ((n, k, _), c, blocks) in
           enumerate(zip(sizes, cfg["widths"], cfg["encoder_blocks"])) for _ in range(blocks)]
    dec = [(s + 1, n, k, c) for s, ((n, k, _), c, blocks) in
           reversed(list(enumerate(zip(sizes, cfg["widths"], cfg["decoder_blocks"]))))
           for _ in range(blocks)]
    return enc + dec


def attn_products(n: int, k: int, c: int, share: int) -> int:
    """Multiply-adds of one vector attention over n points of k neighbours:
    q, k and v a point (3 C^2); the position encoding (3 x 3 + 3 x C) and
    the weight MLP (C x C/s + (C/s)^2) a neighbour."""
    return n * 3 * c * c + n * k * (9 + 3 * c + c * (c // share) + (c // share) ** 2)


def attn_elementwise(n: int, k: int, c: int, share: int) -> int:
    """Operations of one vector attention over n points of k neighbours that
    no product holds, a neighbour: the relation k_j - q_i + delta_ij (2 C),
    the relus after the position encoding's and the weight MLP's BatchNorms
    (3 + C + C/s), the softmax over the neighbours (an exponential, a sum and
    a divide, 3 C/s), and v_j + delta_ij times its weight, summed (3 C). The
    BatchNorms themselves are not counted: each folds into the product
    before it."""
    return n * k * (3 + 6 * c + 4 * (c // share))


def forward_flops(cfg: dict, width: int) -> float:
    """Operations of the equations' products for one cloud of ``width``
    points, two a multiply-add: each block's W1 and W3 (2 C^2 a point) and
    its attention (:func:`attn_products`); the stem, the transitions' grouped
    and skip dense layers, the head transition's global layer once a cloud;
    the heads; the distance products of the self, down and up searches
    (3 a pair)."""
    sizes, widths, share = stage_sizes(cfg, width), cfg["widths"], cfg["share_planes"]
    ops = width * 3 * widths[0]
    for s, ((n, k, group), c) in enumerate(zip(sizes, widths)):
        blocks = cfg["encoder_blocks"][s] + cfg["decoder_blocks"][s]
        ops += blocks * (2 * n * c * c + attn_products(n, k, c, share))
        ops += 3 * n * n
        if s > 0:
            prev_n, prev_c = sizes[s - 1][0], widths[s - 1]
            ops += n * group * (3 + prev_c) * c + 3 * n * prev_n  # down
            ops += prev_n * prev_c * prev_c + n * c * prev_c + 3 * prev_n * n  # up
    n5, c5 = sizes[-1][0], widths[-1]
    ops += c5 * c5 + n5 * 2 * c5 * c5  # the head transition
    cls, seg = cfg["classification_head"], cfg["segmentation_head"]
    ops += c5 * cls[0] + sum(a * b for a, b in zip(cls, cls[1:]))
    ops += width * (widths[0] * seg[0] + seg[0] * seg[1])
    return 2.0 * ops

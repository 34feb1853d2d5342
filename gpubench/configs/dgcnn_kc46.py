"""``dgcnn_kc46``: the port's ``models/dgcnn.py::dgcnn_for_width(23, 12, 1024,
k=20)``, the published dynamic-graph network (EdgeConv 64, 64, 128, 256,
embedding 1024) with the multi-head heads, in f32, and its twin in the
reference.

The file beside this one (``dgcnn_kc46.json``) holds the sizes as run.

The network makes discrete choices on computed features: each layer's kNN
graph. The program builds it from an f32 expansion of the distances on its
factored features, the reference from float64 distances of its own literal
features, and a near-tie that rounding breaks one way in one and the other
way in the other swaps a neighbour and moves the heads by ~1e-4, as far as
TF32 moves them. So the reference replays the program on the same points,
records its graphs, and takes the program's set in a row only where that
set is a near-tie of its own exact one, k distinct points within tau of it
(``reference/dgcnn.py::take_ties``): a tie broken differently then reads
as agreement, and a wrong graph shows as a head gap.
"""

from __future__ import annotations

import sys

import torch

from gpubench.reference import dgcnn as reference

#: tau's constant, in units of ``2^-23 (|x_i|^2 + max_j |x_j|^2)``: a row takes
#: the program's set where the farthest of it lies at most this far past the
#: reference's own k-th distance. The rounding of the program's f32 expansion
#: ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j`` over up to 128 channels, plus the two
#: dataflows' rounding of the features (the factored p + q against the literal
#: edge tensor), which feeds each later layer. Set between the readings on the
#: H100 (PERF.md): the largest excess that sound runs took, and the smallest
#: that the largest excess of a graph built on TF32 features reaches.
TIE_SCALE = 16.0


def build_program(cfg: dict, device, train: bool = False):
    """The port's model as the configuration states it, on ``device``,
    through its normal constructor (``edge_impl='auto'``: the factored edge
    block through ``gather_maxmin`` on CUDA); its graph, k and widths must
    be the configuration's."""
    from pointcloudprocessing_tpu_torch.models.dgcnn import dgcnn_for_width

    model = dgcnn_for_width(cfg["num_classes"], cfg["num_parts"], cfg["input_width"],
                            k=cfg["k"], edge_widths=tuple(cfg["edge_widths"]),
                            emb_width=cfg["emb_width"], dropout_rate=cfg["dropout_rate"],
                            edge_impl="auto", graph=cfg["graph"], device=device)
    built = (model.k, list(model.edge_widths), model.emb.conv.weight.shape[0], model.graph)
    stated = (cfg["k"], cfg["edge_widths"], cfg["emb_width"], cfg["graph"])
    if built != stated:
        raise ValueError(f"the program's (k, edge widths, embedding, graph) are {built}, "
                         f"the configuration's {stated}")
    return model.train(train)


def replay(program, points: torch.Tensor) -> list[torch.Tensor]:
    """The kNN graphs that the program's eval forward on ``points`` builds,
    in order, recorded by a stand-in for ``models.dgcnn.knn_graph`` for the
    call only."""
    from pointcloudprocessing_tpu_torch.models import dgcnn as program_dgcnn

    real, graphs = program_dgcnn.knn_graph, []

    def recording(feats, k):
        idx = real(feats, k)
        graphs.append(idx)
        return idx

    program_dgcnn.knn_graph = recording
    try:
        with torch.inference_mode():
            program(points)
    finally:
        program_dgcnn.knn_graph = real
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
        heads, ties = reference.forward(weights, points, cfg["k"], len(cfg["edge_widths"]),
                                        graph=cfg["graph"], program_graphs=graphs,
                                        scale=TIE_SCALE)
        print("dgcnn reference: the program's set taken in "
              + ", ".join(f"{t.taken} of {t.differ}" for t in ties)
              + " differing rows by graph; largest excess taken "
              + ", ".join(f"{t.largest_taken:.3g}" for t in ties)
              + "; largest excess of the differing rows "
              + ", ".join(f"{t.largest_differ:.3g}" for t in ties)
              + f" (tau's constant {TIE_SCALE:g})", file=sys.stderr)
        return heads
    return forward


def model_fps(cfg: dict, width: int) -> list[tuple[int, int]]:
    """FPS calls inside the model a cloud, (points, picks): none."""
    return []


def edge_gathers(cfg: dict) -> list[tuple[int, int]]:
    """The calls of ``gather_maxmin`` (kernel 7) a forward, (w, k): one an
    EdgeConv."""
    return [(w, cfg["k"]) for w in cfg["edge_widths"]]


def _products(widths) -> int:
    return sum(a * b for a, b in zip(widths, widths[1:]))


def forward_flops(cfg: dict, width: int) -> float:
    """Operations of the equations' products for one cloud of ``width``
    points, two a multiply-add: each layer's distance product (n^2 c_in),
    its edge MLP as the exact rewrite needs it (p and q, 2 n c_in w, so no
    count passes what the rewrite avoids), the embedding, and the heads;
    the global feature's product in ``mlp_seg_1``, which every point shares,
    once a cloud."""
    widths, seg = cfg["edge_widths"], cfg["segmentation_head"]
    ins = (3, *widths[:-1])
    ops = sum(width * width * c for c in ins)
    ops += sum(2 * width * c * w for c, w in zip(ins, widths))
    ops += width * sum(widths) * cfg["emb_width"]
    ops += _products((cfg["emb_width"], *cfg["classification_head"]))
    ops += width * (seg["local"] * seg["widths"][0] + _products(seg["widths"]))
    ops += seg["global"] * seg["widths"][0]
    return 2.0 * ops

"""``pointnet2_ssg_kc46``: the port's ``models/pointnet2.py::pointnet2_for_width(
23, 12, 1024)``, the canonical SSG at 1,024 points, in f32, and its twin in
the reference.

The file beside this one (``pointnet2_ssg_kc46.json``) holds the sizes as run.
"""

from __future__ import annotations

from gpubench.reference import pointnet2 as reference


def _sa(cfg: dict, key: str) -> tuple:
    sa = cfg[key]
    return sa["centroids"], sa["k"], sa["radius"]


def build_program(cfg: dict, device, train: bool = False):
    """The port's model as the configuration states it, on ``device``; its
    set abstractions must be the configuration's."""
    from pointcloudprocessing_tpu_torch.models.pointnet2 import pointnet2_for_width

    model = pointnet2_for_width(cfg["num_classes"], cfg["num_parts"], cfg["input_width"],
                                dropout_rate=cfg["dropout_rate"], device=device)
    for key in ("sa1", "sa2"):
        sa = getattr(model, key)
        if (sa.num_centroids, sa.k, sa.radius) != _sa(cfg, key):
            raise ValueError(f"the program's {key} is {(sa.num_centroids, sa.k, sa.radius)}, "
                             f"the configuration's {_sa(cfg, key)}")
    return model.train(train)


def reference_forward(cfg: dict, weights: dict):
    """The reference's eval forward over ``weights``: points -> heads."""
    def forward(points):
        return reference.forward(weights, points, _sa(cfg, "sa1"), _sa(cfg, "sa2"),
                                 dropout_rate=cfg["dropout_rate"])
    return forward


def model_fps(cfg: dict, width: int) -> list[tuple[int, int]]:
    """FPS calls inside the model a cloud, (points, picks): SA1 and SA2."""
    return [(width, cfg["sa1"]["centroids"]),
            (cfg["sa1"]["centroids"], cfg["sa2"]["centroids"])]


def _products(widths) -> int:
    return sum(a * b for a, b in zip(widths, widths[1:]))


def forward_flops(cfg: dict, width: int) -> float:
    """Operations of the published equations' products for one cloud of
    ``width`` points, two a multiply-add: the grouped MLPs over every
    neighbour, the global abstraction, the heads, and the distance products
    of the kNN and 3-NN searches; the global feature's product in the first
    propagation layer, which every centroid shares, once a cloud."""
    sa1, sa2 = cfg["sa1"], cfg["sa2"]
    m1, k1, m2, k2 = sa1["centroids"], sa1["k"], sa2["centroids"], sa2["k"]
    g = cfg["sa3_mlp"][-1]
    fp2, fp1 = cfg["feature_propagation"]["fp2"], cfg["feature_propagation"]["fp1"]
    head = cfg["feature_propagation"]["head"]
    ops = m1 * k1 * _products((3, *sa1["mlp"]))
    ops += m2 * k2 * _products((3 + sa1["mlp"][-1], *sa2["mlp"]))
    ops += m2 * _products((3 + sa2["mlp"][-1], *cfg["sa3_mlp"]))
    ops += _products((g, *cfg["classification_head"]))
    ops += m2 * (sa2["mlp"][-1] * fp2[0] + _products(fp2)) + g * fp2[0]
    ops += m1 * ((sa1["mlp"][-1] + fp2[-1]) * fp1[0] + _products(fp1))
    ops += width * _products((fp1[-1], *head))
    ops += 3 * (m1 * width + m2 * m1 + m1 * m2 + width * m1)  # distance products
    return 2.0 * ops

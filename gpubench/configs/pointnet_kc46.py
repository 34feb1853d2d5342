"""``pointnet_kc46``: the port's ``models/pointnet.py::PointNet(23, 12)`` with
both T-Nets and both regularizers, in f32, and its twin in the reference.

The file beside this one (``pointnet_kc46.json``) holds the sizes as run.
"""

from __future__ import annotations

import functools

from gpubench.reference import pointnet as reference


def build_program(cfg: dict, device, train: bool = False):
    """The port's model as the configuration states it, on ``device``."""
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet

    model = PointNet(cfg["num_classes"], cfg["num_parts"], vanilla=False,
                     dropout_rate=cfg["dropout_rate"],
                     regularize_input_transform=cfg["regularize_input_transform"],
                     regularize_feature_transform=cfg["regularize_feature_transform"],
                     device=device)
    return model.train(train)


def reference_forward(cfg: dict, weights: dict):
    """The reference's eval forward over ``weights``: points -> heads."""
    def forward(points):
        return reference.forward(weights, points, dropout_rate=cfg["dropout_rate"])[0]
    return forward


def model_fps(cfg: dict, width: int) -> list[tuple[int, int]]:
    """FPS calls inside the model a cloud, (points, picks): none."""
    return []


@functools.cache
def _products(widths: tuple) -> int:
    return sum(a * b for a, b in zip(widths, widths[1:]))


def forward_flops(cfg: dict, width: int) -> float:
    """Operations of the published equations' products for one cloud of
    ``width`` points, two a multiply-add; a product that every point of a
    cloud shares (the segmentation head's global term) once a cloud."""
    t_in, t_feat = cfg["input_transform"], cfg["feature_transform"]
    mlp1, mlp2 = cfg["shared_mlp_1"], cfg["shared_mlp_2"]
    seg = cfg["segmentation_head"]
    per_point = (
        _products((t_in["k"], *t_in["conv"])) + t_in["k"] ** 2
        + _products((t_in["k"], *mlp1))
        + _products((mlp1[-1], *t_feat["conv"])) + t_feat["k"] ** 2
        + _products((t_feat["k"], *mlp2))
        + seg["local"] * seg["widths"][0] + _products(tuple(seg["widths"])))
    per_cloud = sum(
        _products((t["conv"][-1], *t["dense"], t["k"] ** 2)) for t in (t_in, t_feat))
    per_cloud += _products((mlp2[-1], *cfg["classification_head"]))
    per_cloud += seg["global"] * seg["widths"][0]
    return 2.0 * (per_point * width + per_cloud)


def pooled_chains(cfg: dict) -> list[tuple[int, int]]:
    """The dense -> BatchNorm -> relu -> max-pool chains of one forward,
    (c_in, c): each T-Net's last conv and the trunk's last layer."""
    return [tuple(cfg["input_transform"]["conv"][-2:]),
            tuple(cfg["feature_transform"]["conv"][-2:]),
            tuple(cfg["shared_mlp_2"][-2:])]

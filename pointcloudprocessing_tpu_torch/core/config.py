"""Typed training-configuration schema (the port's copy of
``pointcloudprocessing_tpu/core/config.py``, which the port may not import).

The public config surface is the same JSON schema the reference consumes
(reference: ``point_cloud_analysis/kc46_lidar_config.json:1-118`` and the
field extraction in ``pointnet_train.py:83-114``):

.. code-block:: text

    info{name, class_labels, part_labels,
         training_profiles{<stage>{datasets, noise{x,y,z_stdev_m},
                                   trainable{shared_network, input_transform,
                                             classification_head, segmentation_head},
                                   loss_weights{classification, segmentation, rotation},
                                   monitor}},
         continue_training_model}
    params{input_width, epochs, patience, batch_size,
           learning{rate, decay_steps, decay_rate},
           random_seed, debugging, vanilla,
           regularize_input_transform, regularize_feature_transform,
           [compute_dtype], [model],
           [model_options], [optimizer_moment_dtype]}  # extensions; absent = reference behavior
    file_system{model_path, input_path, data_path}

Here it is parsed into frozen dataclasses so that the rest of the framework
gets typed, hashable (jit-static-friendly) config objects instead of dicts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping


# copied from pointcloudprocessing_tpu/core/config.py::LearningConfig
@dataclasses.dataclass(frozen=True)
class LearningConfig:
    rate: float = 1e-4
    decay_steps: int = 7000
    decay_rate: float = 0.7


# copied from pointcloudprocessing_tpu/core/config.py::NoiseConfig
@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    x_stdev_m: float = 0.0
    y_stdev_m: float = 0.0
    z_stdev_m: float = 0.0

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.x_stdev_m, self.y_stdev_m, self.z_stdev_m)


# copied from pointcloudprocessing_tpu/core/config.py::TrainableConfig
@dataclasses.dataclass(frozen=True)
class TrainableConfig:
    """Per-stage freeze/thaw switches (reference: pointnet_train.py:322-332).

    The reference applies them in order: shared_network first (which also
    freezes/thaws both T-Nets), then input_transform overrides the input
    T-Net specifically.
    """

    shared_network: bool = True
    input_transform: bool = True
    classification_head: bool = True
    segmentation_head: bool = True


# copied from pointcloudprocessing_tpu/core/config.py::LossWeights
@dataclasses.dataclass(frozen=True)
class LossWeights:
    classification: float = 1.0
    segmentation: float = 1.0
    rotation: float = 1.0


# copied from pointcloudprocessing_tpu/core/config.py::StageConfig
@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One curriculum stage (one key under ``info.training_profiles``)."""

    name: str
    datasets: tuple[str, ...] = ()
    noise: NoiseConfig = NoiseConfig()
    trainable: TrainableConfig = TrainableConfig()
    loss_weights: LossWeights = LossWeights()
    monitor: str = "val_loss"


# copied from pointcloudprocessing_tpu/core/config.py::TrainConfig
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    class_labels: tuple[str, ...]
    part_labels: tuple[str, ...]
    stages: tuple[StageConfig, ...]
    continue_training_model: str = ""

    input_width: int = 1024
    epochs: int = 100
    patience: int = 30
    batch_size: int = 32
    learning: LearningConfig = LearningConfig()
    random_seed: int = 42
    debugging: bool = False
    vanilla: bool = False
    regularize_input_transform: bool = False
    regularize_feature_transform: bool = False
    # extension over the reference schema (absent key = f32 = reference
    # behavior): "bfloat16" runs the trunk in MXU-native precision — ~1.7x
    # train-step throughput on v5e; heads and softmaxes stay f32
    compute_dtype: str = ""
    # extension over the reference schema (absent key = "pointnet" = the
    # reference architecture): "pointnet2" trains the hierarchical
    # set-abstraction family (models/pointnet2.py) through the same
    # curriculum/driver; vanilla/regularize_* flags do not apply to it
    model: str = "pointnet"
    # extension over the reference schema: per-family architecture options,
    # validated by models/factory.py::model_from_config. DGCNN accepts
    # {"k": <int>, "graph": "dynamic"|"static"} (the serving opt-ins of the
    # DGCNN serving table, docs/PERF.md); other families accept no options.
    model_options: Mapping[str, object] = dataclasses.field(default_factory=dict)
    # extension over the reference schema (absent = f32 = reference
    # behavior): "bfloat16" stores both Adam moments rounded to bf16 —
    # halves the optimizer-state HBM traffic the round-5 train-step gap
    # trace measured at the scan-iteration boundary (docs/PERF.md
    # "Training-step wall"); update math stays f32
    optimizer_moment_dtype: str = ""

    model_path: str = "models/"
    input_path: str = ""
    data_path: str = "data/"

    @property
    def num_classes(self) -> int:
        return len(self.class_labels)

    @property
    def num_parts(self) -> int:
        return len(self.part_labels)


# copied from pointcloudprocessing_tpu/core/config.py::_labels_in_index_order
def _labels_in_index_order(table: Mapping[str, str]) -> tuple[str, ...]:
    """The reference keeps label maps as {"0": "wing", ...} JSON objects and
    consumes ``list(values())`` (pointnet_train.py:84-85); JSON objects keep
    insertion order, so we sort by integer key to be robust to re-serialized
    configs while producing the identical ordering for well-formed files."""
    try:
        return tuple(table[k] for k in sorted(table, key=int))
    except (ValueError, TypeError):
        return tuple(table.values())


# copied from pointcloudprocessing_tpu/core/config.py::parse_config
def parse_config(config: Mapping) -> TrainConfig:
    info = config["info"]
    params = config["params"]
    fs = config.get("file_system", {})

    stages = []
    for stage_name, prof in info.get("training_profiles", {}).items():
        noise = prof.get("noise", {})
        trainable = prof.get("trainable", {})
        weights = prof.get("loss_weights", {})
        stages.append(
            StageConfig(
                name=stage_name,
                datasets=_labels_in_index_order(prof.get("datasets", {})),
                noise=NoiseConfig(
                    x_stdev_m=float(noise.get("x_stdev_m", 0.0)),
                    y_stdev_m=float(noise.get("y_stdev_m", 0.0)),
                    z_stdev_m=float(noise.get("z_stdev_m", 0.0)),
                ),
                trainable=TrainableConfig(
                    shared_network=bool(trainable.get("shared_network", True)),
                    input_transform=bool(trainable.get("input_transform", True)),
                    classification_head=bool(trainable.get("classification_head", True)),
                    segmentation_head=bool(trainable.get("segmentation_head", True)),
                ),
                loss_weights=LossWeights(
                    classification=float(weights.get("classification", 1.0)),
                    segmentation=float(weights.get("segmentation", 1.0)),
                    rotation=float(weights.get("rotation", 1.0)),
                ),
                monitor=prof.get("monitor", "val_loss"),
            )
        )

    learning = params.get("learning", {})
    return TrainConfig(
        name=info["name"],
        class_labels=_labels_in_index_order(info["class_labels"]),
        part_labels=_labels_in_index_order(info["part_labels"]),
        stages=tuple(stages),
        continue_training_model=info.get("continue_training_model", ""),
        input_width=int(params["input_width"]),
        epochs=int(params["epochs"]),
        patience=int(params["patience"]),
        batch_size=int(params["batch_size"]),
        learning=LearningConfig(
            rate=float(learning.get("rate", 1e-4)),
            decay_steps=int(learning.get("decay_steps", 7000)),
            decay_rate=float(learning.get("decay_rate", 0.7)),
        ),
        random_seed=int(params.get("random_seed", 42)),
        debugging=bool(params.get("debugging", False)),
        vanilla=bool(params.get("vanilla", False)),
        regularize_input_transform=bool(params.get("regularize_input_transform", False)),
        regularize_feature_transform=bool(params.get("regularize_feature_transform", False)),
        compute_dtype=str(params.get("compute_dtype", "")),
        model=str(params.get("model", "pointnet")),
        model_options=dict(params.get("model_options", {})),
        optimizer_moment_dtype=str(params.get("optimizer_moment_dtype", "")),
        model_path=fs.get("model_path", "models/"),
        input_path=fs.get("input_path", ""),
        data_path=fs.get("data_path", "data/"),
    )


# copied from pointcloudprocessing_tpu/core/config.py::load_config
def load_config(path: str) -> TrainConfig:
    with open(path, "r") as f:
        return parse_config(json.load(f))

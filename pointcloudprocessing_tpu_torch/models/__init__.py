"""Models of the port (counterparts of ``pointcloudprocessing_tpu/models``)."""

from pointcloudprocessing_tpu_torch.models.layers import PointwiseBlock, DenseBlock
from pointcloudprocessing_tpu_torch.models.tnet import TNet
from pointcloudprocessing_tpu_torch.models.pointnet import (
    PointNet,
    FreezeFlags,
    NOTHING_FROZEN,
    freeze_flags_from_trainable,
    layer_trainability,
)
from pointcloudprocessing_tpu_torch.models.pointnet2 import PointNet2
from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
from pointcloudprocessing_tpu_torch.models.point_transformer import PointTransformer
from pointcloudprocessing_tpu_torch.models.classifier import (
    PointNetClassifier,
    TNetRegressor,
)
from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

__all__ = [
    "PointwiseBlock",
    "DenseBlock",
    "TNet",
    "PointNet",
    "PointNet2",
    "DGCNN",
    "PointTransformer",
    "FreezeFlags",
    "NOTHING_FROZEN",
    "freeze_flags_from_trainable",
    "layer_trainability",
    "PointNetClassifier",
    "TNetRegressor",
    "PointCloudPipeline",
]

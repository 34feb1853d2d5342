"""Backend-free configuration schema and constants, copied from the JAX
package's ``core`` so that the port imports nothing of it."""

from pointcloudprocessing_tpu_torch.core import constants
from pointcloudprocessing_tpu_torch.core.config import (
    LearningConfig,
    LossWeights,
    NoiseConfig,
    StageConfig,
    TrainableConfig,
    TrainConfig,
    load_config,
    parse_config,
)

__all__ = [
    "constants",
    "LearningConfig",
    "NoiseConfig",
    "TrainableConfig",
    "LossWeights",
    "StageConfig",
    "TrainConfig",
    "load_config",
    "parse_config",
]

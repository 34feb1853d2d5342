"""Model export: the native opset-13 ONNX writer and interpreter, a
``torch.export`` program, Keras weight interop and the export CLI.

The JAX package's ``export_stablehlo`` and ``load_stablehlo`` have
``export_program`` and ``load_program`` (a ``.pt2`` program) in their
place; its ``export_tf_savedmodel`` has no twin."""

from pointcloudprocessing_tpu_torch.export.keras_compat import (
    flax_variables_from_keras_pointnet,
    state_dict_from_keras_classifier,
    state_dict_from_keras_pointnet,
    state_dict_from_keras_tnet_regressor,
)
from pointcloudprocessing_tpu_torch.export.onnx_bridge import (
    export_onnx,
    onnx_available,
    verify_onnx,
)
from pointcloudprocessing_tpu_torch.export.pt2 import (
    export_program,
    load_program,
)

__all__ = [
    "flax_variables_from_keras_pointnet",
    "state_dict_from_keras_pointnet",
    "state_dict_from_keras_classifier",
    "state_dict_from_keras_tnet_regressor",
    "export_program",
    "load_program",
    "export_onnx",
    "onnx_available",
    "verify_onnx",
]

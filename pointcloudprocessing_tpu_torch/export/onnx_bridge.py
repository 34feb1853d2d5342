"""ONNX export bridge (``pointcloudprocessing_tpu/export/onnx_bridge.py``).

The JAX bridge exports through jax -> jax2tf -> tf2onnx when that toolchain
is installed and falls back to the native opset-13 writer otherwise. The
port has no jax2tf, and ``torch.onnx.export`` needs ``onnx``/``onnxscript``,
so it always writes with the native writer (export/onnx_native.py) and
prints the JAX bridge's advisory. :func:`verify_onnx` re-runs a file
through onnxruntime when installed, else the native interpreter.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

# copied from pointcloudprocessing_tpu/export/onnx_bridge.py::GATING_MESSAGE
GATING_MESSAGE = (
    "ONNX toolchain (tf2onnx/onnx) not installed — exporting with the "
    "native opset-13 writer (export/onnx_native.py) instead; the artifact "
    "is verified in-image by its bundled numpy interpreter, and "
    "onnxruntime re-inference applies wherever the file is consumed."
)


# copied from pointcloudprocessing_tpu/export/onnx_bridge.py::onnx_available
def onnx_available() -> bool:
    """True when the JAX bridge's toolchain (tensorflow, tf2onnx, onnx)
    imports. The port's writer needs none of it."""
    try:
        import tensorflow  # noqa: F401
        import tf2onnx  # noqa: F401
        import onnx  # noqa: F401
    except ImportError:
        return False
    return True


def export_onnx(
    model: nn.Module,
    input_width: int,
    path: str,
    opset: int = 13,
    print_func: Callable[[str], None] = print,
) -> bool:
    """Export a torch model's inference graph as ONNX (reference parity:
    opset 13, outputs cls (-1, C), seg (-1, n, P), se3 (-1, 3, 3)) with the
    native writer. Returns True on success; a model family the writer does
    not cover gets an advisory and False."""
    from pointcloudprocessing_tpu_torch.export import onnx_native
    from pointcloudprocessing_tpu_torch.models.dgcnn import DGCNN
    from pointcloudprocessing_tpu_torch.models.pointnet import PointNet
    from pointcloudprocessing_tpu_torch.models.pointnet2 import PointNet2

    if isinstance(model, PointNet):
        emit = onnx_native.export_onnx_native
    elif isinstance(model, PointNet2):
        emit = onnx_native.export_onnx_native_pointnet2
    elif isinstance(model, DGCNN):
        emit = onnx_native.export_onnx_native_dgcnn
    else:
        print_func(
            f"ONNX export for {type(model).__name__} is not covered by the "
            "native opset-13 writer (PointNet/PointNet2/DGCNN); the .pt2 "
            "program (export/pt2.py) remains the portable artifact for this "
            "model."
        )
        return False
    print_func(GATING_MESSAGE)
    emit(model, input_width, path, print_func=print_func, opset=opset)
    return True


# copied from pointcloudprocessing_tpu/export/onnx_bridge.py::verify_onnx
def verify_onnx(path: str, points, print_func: Callable[[str], None] = print):
    """Re-run an exported ONNX model (the notebook's parity check,
    pointnet_train.ipynb cells 15-18): through onnxruntime when installed,
    otherwise through the native numpy interpreter
    (export/onnx_native.py::run_onnx — executes the opset-13 subset the
    native exporter emits). Returns the output list, or None if neither
    engine can run the file."""
    import numpy as np

    try:
        import onnxruntime as ort
    except ImportError:
        from pointcloudprocessing_tpu_torch.export.onnx_native import (
            parse_model,
            run_onnx,
        )

        try:
            parsed = parse_model(open(path, "rb").read())
            out = run_onnx(parsed, {
                parsed["inputs"][0]: np.asarray(points, np.float32)
            })
        except Exception as e:  # missing file, foreign-producer encodings
            # (e.g. tf2onnx packed repeated fields), unimplemented ops —
            # degrade like the old no-onnxruntime path, never raise
            print_func(
                f"onnxruntime is not installed and the native interpreter "
                f"cannot execute this file ({type(e).__name__}: {e}); "
                f"skipping the ONNX re-inference check."
            )
            return None
        print_func(
            "onnxruntime is not installed; re-inferred through the native "
            "numpy interpreter instead."
        )
        return [out[name] for name in parsed["outputs"]]
    session = ort.InferenceSession(path)
    input_name = session.get_inputs()[0].name
    return session.run(None, {input_name: np.asarray(points, np.float32)})

"""Model export as a ``torch.export`` program (the counterpart of
``pointcloudprocessing_tpu/export/stablehlo.py``).

The JAX package serializes its jitted inference function as StableHLO with
a symbolic batch, in the pure-XLA formulation, so the artifact loads in any
JAX install. Here the inference function becomes a ``.pt2`` file
(``torch.export.save``) with a symbolic batch (``torch.export.Dim``), in the
plain PyTorch formulation, so it loads with ``torch.export.load`` in a
process that never imports this package. Output signature as the
reference's ONNX graph: cls (-1, C), seg (-1, n, P), se3 (-1, 3, 3).

The port picks its kernels by device (a CUDA tensor takes the hand-written
kernel, a CPU one its plain version), and a ctypes kernel call cannot be
traced. So the program is traced from a CPU copy of the model in eval
mode, which runs the plain formulation of every kernel (FPS as the
kernel's plain version kept as one ``while_loop``, ``ops/fps.py``; DGCNN's
literal edge dataflow), and then moved to the requested device with
``torch.export.passes.move_to_device_pass``. The artifact calls no kernel of
the port. Its matmuls are plain f32 ``aten`` products, which TF32 would
round: a loading process that turns TF32 on for matmuls
(``torch.backends.cuda.matmul.allow_tf32``) changes its numbers.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from pointcloudprocessing_tpu_torch.utils.device import require_device


class InferenceProgram(nn.Module):
    """A model's forward as the reference's output tuple ``(cls, seg,
    se3)`` (``stablehlo.py::make_inference_fn``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, points: torch.Tensor):
        out = self.model(points)
        return (out["classification_output"], out["segmentation_output"],
                out["se3"])


def _plain_copy(model: nn.Module) -> InferenceProgram:
    """An eval-mode CPU copy of ``model`` as an :class:`InferenceProgram`,
    its parameters without gradients: the form :func:`export_program`
    traces."""
    copied = copy.deepcopy(model).cpu().eval()
    for p in copied.parameters():
        p.requires_grad_(False)
    return InferenceProgram(copied)


def export_program(model: nn.Module, input_width: int, path: str,
                   batch_size: int | None = None, device="cuda"):
    """Trace ``model``'s inference function from a CPU copy, move it to
    ``device`` (CUDA unless the caller asks for the CPU; without CUDA the
    default raises) and save it at ``path``. ``batch_size=None`` exports a
    symbolic batch dimension (the reference ONNX graph's -1 batch). Returns
    the ``ExportedProgram``."""
    device = require_device(device)
    program = _plain_copy(model)
    example = torch.zeros((2 if batch_size is None else batch_size,
                           input_width, 3))
    # a size-1 example would specialize the batch; any size runs
    shapes = None if batch_size is not None else {
        "points": {0: torch.export.Dim("b")}}
    with torch.no_grad():
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes=shapes)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    torch.export.save(exported, path)
    return exported


def load_program(path: str):
    """Load a saved program (``torch.export.load``); call it as
    ``load_program(path).module()(points)``. Kept beside ``torch.export.load``
    for the JAX package's API (``stablehlo.py::load_stablehlo``)."""
    return torch.export.load(path)


def export_pointnet(model: nn.Module, input_width: int, path_prefix: str,
                    device="cuda") -> str:
    """Stage-artifact export used by the trainer: writes
    ``{path_prefix}.pt2`` and returns its path. Named as the JAX package's
    ``stablehlo.py::export_pointnet``, which writes its artifacts from a
    path prefix the same way."""
    path = f"{path_prefix}.pt2"
    export_program(model, input_width, path, device=device)
    return path

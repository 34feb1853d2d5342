"""What the runners share: the program's model with the benchmark's weights,
the device's description, and the records a runner hands back to
``run.py``."""

from __future__ import annotations

import dataclasses
import subprocess

import torch

from gpubench.harness.check import Compared
from gpubench.harness.registry import Cell
from gpubench.harness.trace import Stretch
from gpubench.harness.weights import make_weights


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads: one whole traced stretch of
    the timed path and the shapes of the work in it."""

    kind: str                 # the runner's kind: "serve_stream" or "train_step"
    stretch: Stretch
    units: int                # batches (serving) or steps (training) in the stretch
    clouds: int               # clouds they carried
    cell: Cell
    #: serving: the occupied voxels of each cloud of each batch of the
    #: stretch, from the reference voxel downsample
    valid: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    """A runner's result: the end-to-end metrics (untraced run) or the
    reading of a stretch (traced run), and the comparison."""

    attempted: int
    failed: int
    compared: list[Compared]
    memory_peak_bytes: int
    metrics: dict = dataclasses.field(default_factory=dict)
    reading: Reading | None = None
    #: every gap worked out, held or not
    numbers: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(c.ok for c in self.compared)


def program_with_weights(cell: Cell, seed: int, device, train: bool = False):
    """The configuration's model from the program, with the benchmark's
    weights for ``seed`` loaded; returns (model, weights)."""
    model = cell.model.build_program(cell.config, device, train=train)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = make_weights(shapes, seed, device)
    model.load_state_dict(weights)
    return model, weights


def power_limit() -> str:
    """``nvidia-smi``'s power limit of the first card, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def device_info(device: torch.device, count: int, memory_peak_bytes: int) -> dict:
    """The result line's ``device``, with the card's power limit beside it.
    A run on the CPU (the harness's tests) says so."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit": power_limit()}


def fixed_precision() -> None:
    """The configurations state float32 with TF32 off: make sure of it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""Per-kernel device-time breakdown of a workload via torch.profiler, with
the PyTorch port (twin of ``tools/trace_ops.py``).

Runs one of the JAX tool's workloads on the card under
``utils/profiling.device_trace`` (every CUDA call that launched device
work checked to have its device row) and prints the device time a step,
then the kernels by total device time: us a step, share, rows a step,
named as CUPTI reports them (a hand-written kernel under its CUDA symbol,
copies and memsets under their own names); then the device time a step by
the program's ``pcp.`` span that launched it (``utils/profiling.by_span``:
the train step's forward, backward, metrics and optimizer).

Usage:
  python tools/torch/trace_ops.py train       # b32/1024pt bf16 train step, 2 x 32 steps
  python tools/torch/trace_ops.py preprocess  # config-2 voxel + window normals
  python tools/torch/trace_ops.py infer       # b2048/1024pt multi-head inference
  python tools/torch/trace_ops.py pn2         # PointNet++ b256/1024pt bf16 inference
  [--device cuda]  (a CUDA device; without CUDA the tool raises)
"""

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Callable

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from pointcloudprocessing_tpu_torch.utils import profiling  # noqa: E402
from pointcloudprocessing_tpu_torch.utils.device import require_device  # noqa: E402

NUM_CLASSES, NUM_PARTS = 23, 12


@dataclasses.dataclass
class Workload:
    """A built and warmed-up workload: ``dispatch()`` runs one dispatch
    (``steps_per_dispatch`` steps) and returns what it computed."""

    name: str
    dispatch: Callable[[], object]
    n_dispatch: int
    steps_per_dispatch: int
    inputs: np.ndarray
    model: torch.nn.Module | None = None

    @property
    def steps(self) -> int:
        return self.n_dispatch * self.steps_per_dispatch


def _warm(workload: Workload, device: torch.device) -> Workload:
    """One dispatch outside the traced window (kernel builds, allocations),
    finished before the window opens."""
    workload.dispatch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return workload


def train(device="cuda", *, chunk: int = 32, batch: int = 32, width: int = 1024,
          n_dispatch: int = 2, dtype=torch.bfloat16, seed: int = 0) -> Workload:
    """The bench-config train step (``trace_ops.py:31-69``): PointNet 23/12
    with both regularizers in ``dtype``, Adam at 1e-4, nothing frozen, loss
    weights (1, 1, 0.1), jitter 0.01 m; a dispatch is ``chunk`` steps over
    ``chunk`` batches of ``batch`` x ``width`` normal points (the port has
    no multi-step: a dispatch is that many calls of the step)."""
    from pointcloudprocessing_tpu_torch.core.config import LearningConfig
    from pointcloudprocessing_tpu_torch.models import FreezeFlags, PointNet
    from pointcloudprocessing_tpu_torch.train import steps

    device = require_device(device)
    model = PointNet(NUM_CLASSES, NUM_PARTS, regularize_input_transform=True,
                     regularize_feature_transform=True,
                     generator=torch.Generator().manual_seed(seed), device=device,
                     dtype=dtype)
    model.train()
    freeze = FreezeFlags()
    state, optimizer = steps.init_train_state(model, LearningConfig(rate=1e-4), freeze)
    step = steps.make_train_step(model, optimizer, (1.0, 1.0, 0.1), freeze,
                                 (0.01, 0.01, 0.01))
    rng = np.random.default_rng(seed)
    xs_np = rng.normal(size=(chunk, batch, width, 3)).astype(np.float32)
    xs = torch.from_numpy(xs_np).to(device)
    targets = {
        "classification_output": torch.from_numpy(
            rng.integers(0, NUM_CLASSES, (chunk, batch))).to(device),
        "segmentation_output": torch.from_numpy(
            rng.integers(0, NUM_PARTS, (chunk, batch, width))).to(device),
        "se3": torch.eye(3, device=device).expand(chunk, batch, 3, 3).contiguous(),
    }

    def dispatch():
        nonlocal state
        logs = None
        for i in range(chunk):
            state, logs = step(state, xs[i], {k: v[i] for k, v in targets.items()}, 1)
        return logs

    return _warm(Workload("train", dispatch, n_dispatch, chunk, xs_np, model), device)


def preprocess(device="cuda", *, batch: int = 8, width: int = 8192,
               n_dispatch: int = 20, seed: int = 0) -> Workload:
    """Config 2 (``trace_ops.py:72-95``): ``batch`` x ``width`` uniform(-30,
    30) points, voxel 0.5, then window normals k 16; returns (voxels,
    mask, normals)."""
    from pointcloudprocessing_tpu_torch.ops.normals import estimate_normals_batch
    from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch

    device = require_device(device)
    pts_np = np.random.default_rng(seed).uniform(
        -30, 30, (batch, width, 3)).astype(np.float32)
    pts = torch.from_numpy(pts_np).to(device)

    def dispatch():
        vox, mask = voxel_downsample_batch(pts, 0.5)
        normals = estimate_normals_batch(vox, k=16, valid_mask=mask, method="window")
        return vox, mask, normals

    return _warm(Workload("preprocess", dispatch, n_dispatch, 1, pts_np), device)


def _inference(name: str, model, device, batch: int, width: int, n_dispatch: int,
               seed: int) -> Workload:
    model.eval()
    pts_np = np.random.default_rng(seed).normal(size=(batch, width, 3)).astype(np.float32)
    pts = torch.from_numpy(pts_np).to(device)

    def dispatch():
        with torch.inference_mode():
            return model(pts)

    return _warm(Workload(name, dispatch, n_dispatch, 1, pts_np, model), device)


def infer(device="cuda", *, batch: int = 2048, width: int = 1024,
          n_dispatch: int = 10, seed: int = 0) -> Workload:
    """Multi-head inference (``trace_ops.py:98-119``): PointNet 23/12 in
    f32, eval, on ``batch`` x ``width`` normal points. With running
    statistics the chain is plain torch: no hand-written kernel runs."""
    from pointcloudprocessing_tpu_torch.models import PointNet

    device = require_device(device)
    model = PointNet(NUM_CLASSES, NUM_PARTS,
                     generator=torch.Generator().manual_seed(seed), device=device)
    return _inference("infer", model, device, batch, width, n_dispatch, seed)


def pn2(device="cuda", *, batch: int = 256, width: int = 1024, n_dispatch: int = 10,
        dtype=torch.bfloat16, seed: int = 0) -> Workload:
    """PointNet++ inference (``trace_ops.py:194-219``):
    ``pointnet2_for_width(23, 12, width)`` in ``dtype``, eval, on ``batch``
    x ``width`` normal points; FPS (kernel 2) twice a forward."""
    from pointcloudprocessing_tpu_torch.models.pointnet2 import pointnet2_for_width

    device = require_device(device)
    model = pointnet2_for_width(NUM_CLASSES, NUM_PARTS, width, device=device,
                                generator=torch.Generator().manual_seed(seed),
                                dtype=dtype)
    return _inference("pn2", model, device, batch, width, n_dispatch, seed)


WORKLOADS = {"train": train, "preprocess": preprocess, "infer": infer, "pn2": pn2}


@dataclasses.dataclass
class Traced:
    """What :func:`measure` read of a workload's traced window."""

    trace: profiling.DeviceTrace | None
    summary: profiling.Summary | None
    window_ms: float      # CUDA events around the window's dispatches
    peak_bytes: int       # device memory allocated at most in the window


def measure(workload: Workload, log_dir: str | None = None) -> Traced:
    """Trace ``workload.n_dispatch`` dispatches in one window on the card,
    with CUDA events around them, the Chrome trace into ``log_dir``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def window():
        start.record()
        for _ in range(workload.n_dispatch):
            workload.dispatch()
        end.record()

    torch.cuda.reset_peak_memory_stats()
    traced = profiling.device_trace(window, log_dir)
    summary = None if traced is None else profiling.summarize(traced.events,
                                                              workload.steps)
    return Traced(traced, summary, start.elapsed_time(end),
                  torch.cuda.max_memory_allocated())


def report(workload: Workload, traced: Traced) -> str:
    """The JAX tool's header line with the window's host wall, then the
    table."""
    if traced.trace is None:
        return f"no device rows in the trace of {workload.name}"
    s = traced.summary
    lines = [f"sync compute: {s.total_us_per_step:.1f} us/step over "
             f"{workload.steps} steps ({s.total_us_per_step * workload.steps / 1e3:.2f} "
             f"ms traced in {traced.trace.wall_us / 1e3:.2f} ms of host wall; "
             f"CUDA events {traced.window_ms:.2f} ms)"]
    lines.append(("trace: " if traced.trace.whole else "NOT WHOLE: ")
                 + "; ".join(a.describe() for a in traced.trace.attempts))
    lines += ["", s.table()]
    if traced.trace.host:
        by_span = profiling.by_span(traced.trace.host + traced.trace.events)
        lines += ["", f"{'us/step':>9}  {'%':>5}  span"]
        lines += [f"{us / workload.steps:9.1f}  {100 * us / sum(by_span.values()):5.1f}  {name}"
                  for name, us in by_span.items()]
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", nargs="?", default="train", choices=sorted(WORKLOADS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    if device.type != "cuda":
        raise SystemExit(f"trace_ops reads device time on a CUDA device, not {device}")
    with torch.cuda.device(device):
        workload = WORKLOADS[args.what](device)
        trace_dir = tempfile.mkdtemp(prefix=f"trace_{args.what}_")
        traced = measure(workload, trace_dir)
    print(f"trace dir: {trace_dir}")
    print(report(workload, traced))
    if args.what == "infer":
        print(f"peak device memory allocated: {traced.peak_bytes / 2**30:.2f} GiB")
    if traced.trace is None or not traced.trace.whole:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

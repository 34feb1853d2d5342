"""End-to-end serving pipeline: raw scans -> preprocess -> model
(``pointcloudprocessing_tpu/models/pipeline.py::PointCloudPipeline``).

Voxel downsample -> FPS, the stride sampler or head truncation -> model
inference, on the model's device. The model is any family with the head
contract (PointNet, PointNet++, DGCNN): ``model(points, heads=...)``
returns a dict of the requested heads. On a CUDA device the voxel segment
sum and FPS run the hand-written kernels of ``csrc/``; the segment sum
takes the any-rank kernel at a scan width that 128 does not divide, as the
JAX package does (``ops/cuda/voxel_reduce.py``).

Usage::

    pipe = PointCloudPipeline(model, scan_width=2048, model_width=1024,
                              voxel_size=0.4)
    for outputs in pipe.stream(scan_batches):   # iterator of (b, n, 3)
        ...
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch
from torch import nn

from pointcloudprocessing_tpu_torch.models.pointnet import ALL_HEADS
from pointcloudprocessing_tpu_torch.ops.fps import (
    farthest_point_sample_and_gather,
    stride_sample_and_gather,
)
from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch


class PointCloudPipeline:
    def __init__(
        self,
        model: nn.Module,
        scan_width: int,
        model_width: int,
        voxel_size: float | None = None,
        sampler: str = "fps",
        heads: tuple[str, ...] = ALL_HEADS,
    ):
        """Args:
        model: a model with the head contract (PointNet, PointNet++,
          DGCNN), with its weights, on the device to serve from.
        scan_width: fixed input scan size (pad/truncate host-side).
        model_width: points fed to the network (<= scan_width).
        voxel_size: optional voxel downsample edge before sampling.
        sampler: "fps" (farthest-point sampling to model_width), "stride"
          (O(n) Morton-stride sampling over the voxel output) or "head"
          (truncation of the voxel output).
        heads: model outputs to compute.
        """
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.scan_width = scan_width
        self.model_width = model_width
        self.voxel_size = voxel_size

        if sampler not in ("fps", "stride", "head"):
            raise ValueError(f"Unknown sampler {sampler!r}")
        if sampler == "stride" and voxel_size is None:
            raise ValueError(
                "sampler='stride' needs the Morton-ordered voxel output; "
                "set voxel_size"
            )
        # FPS from an unmasked full-width scan to the same width is an
        # expensive identity permutation (PointNet is permutation-invariant)
        if voxel_size is None and model_width == scan_width and sampler == "fps":
            sampler = "head"
        self.sampler = sampler
        self.heads = tuple(heads)

    @torch.inference_mode()
    def _run(self, points: torch.Tensor) -> dict[str, torch.Tensor]:
        mask = None
        # plane-major (b, 3, n) between the voxel downsample and FPS: the FPS
        # kernel then loads its coordinate planes with unit stride
        layout = "bcn" if (self.voxel_size is not None and self.sampler == "fps") \
            else "bnc"
        if self.voxel_size is not None:
            points, mask = voxel_downsample_batch(
                points, self.voxel_size, layout=layout
            )
        if self.sampler == "fps":
            _, sampled = farthest_point_sample_and_gather(
                points, self.model_width, mask, layout=layout
            )
        elif self.sampler == "stride":
            _, sampled = stride_sample_and_gather(points, self.model_width, mask)
        else:
            sampled = points[:, : self.model_width]
        return self.model(sampled, heads=self.heads)

    def __call__(self, scans) -> dict[str, torch.Tensor]:
        """One batch: (b, scan_width, 3) array or tensor -> model outputs on
        the model's device."""
        scans = torch.as_tensor(scans, dtype=torch.float32, device=self.device)
        if scans.shape[1] != self.scan_width:
            raise ValueError(
                f"Expected scans of width {self.scan_width}, got {scans.shape[1]}"
            )
        return self._run(scans)

    def _stage(self, batch, copy_stream) -> tuple[torch.Tensor, object]:
        """Host batch -> device tensor, plus the event its copy records."""
        host = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        if copy_stream is None:
            return host.to(self.device), None
        with torch.cuda.stream(copy_stream):
            staged = host.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return staged, done

    def stream(
        self,
        batches: Iterable[np.ndarray],
        prefetch: int = 2,
    ) -> Iterator[dict[str, torch.Tensor]]:
        """Pipelined inference: a background thread stages host batches onto
        the device (pinned memory, non-blocking copies on a side stream)
        while the current batch computes."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()
        copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # the sentinel must reach the consumer even if the source
            # iterator raises — otherwise q.get() blocks forever
            try:
                for batch in batches:
                    if not _put(self._stage(batch, copy_stream)):
                        return
            finally:
                _put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                staged, done = item
                if done is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(done)
                    # the copy stream allocated it; the compute stream uses it
                    staged.record_stream(compute)
                yield self._run(staged)
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.2)

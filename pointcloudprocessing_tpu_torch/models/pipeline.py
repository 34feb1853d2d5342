"""End-to-end serving pipeline: raw scans -> preprocess -> model
(``pointcloudprocessing_tpu/models/pipeline.py::PointCloudPipeline``).

Voxel downsample -> FPS, the stride sampler or head truncation -> model
inference, on the model's device. The model is any family with the head
contract (PointNet, PointNet++, DGCNN): ``model(points, heads=...)``
returns a dict of the requested heads. On a CUDA device the voxel segment
sum and FPS run the hand-written kernels of ``csrc/``; the segment sum
takes the any-rank kernel at a scan width that 128 does not divide, as the
JAX package does (``ops/cuda/voxel_reduce.py``).

``mesh=`` serves data-parallel from one process over a list of devices
(``parallel.mesh.local_mesh``; repeats allowed), as the JAX package's
shard_map serving does: a model replica on each listed device, the batch
split into equal shards (a batch the shard count does not divide raises),
each shard's voxel -> sampler -> model on its device with no collectives,
and the outputs concatenated on the first device.

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

import copy

import numpy as np
import torch
from torch import nn

from pointcloudprocessing_tpu_torch.models.pointnet import ALL_HEADS
from pointcloudprocessing_tpu_torch.ops.fps import (
    farthest_point_sample_and_gather,
    stride_sample_and_gather,
)
from pointcloudprocessing_tpu_torch.ops.voxel import voxel_downsample_batch
from pointcloudprocessing_tpu_torch.parallel.mesh import DataParallelMesh, local_mesh
from pointcloudprocessing_tpu_torch.utils.profiling import span


class PointCloudPipeline:
    def __init__(
        self,
        model: nn.Module,
        scan_width: int,
        model_width: int,
        voxel_size: float | None = None,
        sampler: str = "fps",
        heads: tuple[str, ...] = ALL_HEADS,
        mesh: DataParallelMesh | list | tuple | None = None,
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
        mesh: devices to serve from in parallel (an in-process mesh, or a
          list of devices); None serves on the model's device.
        """
        self.model = model.eval()
        self.device = next(model.parameters()).device
        if mesh is None:
            self.devices = (self.device,)
        else:
            if not isinstance(mesh, DataParallelMesh):
                mesh = local_mesh(mesh)
            if mesh.group is not None:
                raise ValueError("serving takes the in-process form of the mesh "
                                 "(one process over a list of devices)")
            self.devices = mesh.devices
            self.device = self.devices[0]
        # a replica of the model on each device (one for repeats of a device)
        self.replicas = {}
        for device in self.devices:
            if device not in self.replicas:
                self.replicas[device] = (
                    self.model if device == next(model.parameters()).device
                    else copy.deepcopy(self.model).to(device))
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

    def _run(self, shards: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        """One batch's shards, each on its device -> the model outputs,
        concatenated on the first device."""
        with span("pcp.pipeline.batch"):
            outs = [self._run_one(self.replicas[s.device], s) for s in shards]
            if len(outs) == 1:
                return outs[0]
            return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    @torch.inference_mode()
    def _run_one(self, model: nn.Module, points: torch.Tensor) -> dict[str, torch.Tensor]:
        mask = None
        # plane-major (b, 3, n) between the voxel downsample and FPS: the FPS
        # kernel then loads its coordinate planes with unit stride
        layout = "bcn" if (self.voxel_size is not None and self.sampler == "fps") \
            else "bnc"
        if self.voxel_size is not None:
            with span("pcp.pipeline.voxel"):
                points, mask = voxel_downsample_batch(
                    points, self.voxel_size, layout=layout
                )
        with span("pcp.pipeline.sample"):
            if self.sampler == "fps":
                _, sampled = farthest_point_sample_and_gather(
                    points, self.model_width, mask, layout=layout
                )
            elif self.sampler == "stride":
                _, sampled = stride_sample_and_gather(points, self.model_width, mask)
            else:
                sampled = points[:, : self.model_width]
        with span("pcp.pipeline.model"):
            return model(sampled, heads=self.heads)

    def _split(self, b: int) -> list[slice]:
        shards = len(self.devices)
        if b % shards:
            raise ValueError(f"batch of {b} scans does not split into {shards} "
                             "equal shards")
        size = b // shards
        return [slice(i * size, (i + 1) * size) for i in range(shards)]

    def __call__(self, scans) -> dict[str, torch.Tensor]:
        """One batch: (b, scan_width, 3) array or tensor -> model outputs on
        the (first) device."""
        scans = torch.as_tensor(scans, dtype=torch.float32)
        if scans.shape[1] != self.scan_width:
            raise ValueError(
                f"Expected scans of width {self.scan_width}, got {scans.shape[1]}"
            )
        return self._run([scans[rows].to(device) for rows, device in
                          zip(self._split(scans.shape[0]), self.devices)])

    def _stage(self, batch, copy_streams) -> list[tuple[torch.Tensor, object]]:
        """Host batch -> each shard on its device, with the event its copy
        records (None off CUDA)."""
        host = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
        staged = []
        for rows, device in zip(self._split(host.shape[0]), self.devices):
            stream = copy_streams.get(device)
            if stream is None:
                staged.append((host[rows].to(device), None))
                continue
            with torch.cuda.stream(stream):
                shard = host[rows].pin_memory().to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            staged.append((shard, done))
        return staged

    def stream(
        self,
        batches: Iterable[np.ndarray],
        prefetch: int = 2,
    ) -> Iterator[dict[str, torch.Tensor]]:
        """Pipelined inference: a background thread stages host batches onto
        the devices, each shard to its own (pinned memory, non-blocking
        copies on a side stream of each device) while the current batch
        computes."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()
        copy_streams = {d: torch.cuda.Stream(d) for d in self.replicas
                        if d.type == "cuda"}

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
                    with span("pcp.pipeline.stage"):
                        staged = self._stage(batch, copy_streams)
                    if not _put(staged):
                        return
            finally:
                _put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("pcp.pipeline.queue_wait"):
                    item = q.get()
                    if item is None:
                        return
                    for staged, done in item:
                        if done is not None:
                            compute = torch.cuda.current_stream(staged.device)
                            compute.wait_event(done)
                            # the copy stream allocated it; the compute stream uses it
                            staged.record_stream(compute)
                yield self._run([staged for staged, _ in item])
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.2)

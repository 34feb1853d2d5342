"""The port's twin of the repo's ``__graft_entry__.py``: one inference step
on the flagship model, and the multi-device dry run.

- ``entry()`` returns ``(fn, args)``: ``fn(state, points)`` runs the full
  multi-head PointNet (23 classes, 12 parts, the kc46/f15 configuration)
  in eval mode with the parameters and running statistics of ``state`` (a
  ``state_dict``) and returns its heads; ``args`` are the model's own
  seeded state and a batch of 8 x 1,024 zero points. It builds on the card
  unless the caller asks for the CPU.
- ``dryrun_multichip(n, device=...)`` spawns ``n`` ranks in a gloo process
  group (on the CPU, or on the cards, several ranks sharing one where
  there are fewer cards than ranks) and runs the JAX dry run's three legs
  at its tiny shapes: (1) the global-mode train step (the GSPMD step's
  counterpart, at the batch and width of the JAX plan, whose points axis
  the port's row shares stand in for), (2) the shard_map-mode step, 2
  steps, (3) the
  sharded serving pipeline (voxel + FPS + model over an in-process mesh of
  ``n`` devices). Rank 0 prints a line a leg and ``dryrun_multichip OK``.

    fn, args = entry()
    heads = fn(*args)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from pointcloudprocessing_tpu_torch.core.config import LearningConfig
from pointcloudprocessing_tpu_torch.models.pointnet import FreezeFlags, PointNet
from pointcloudprocessing_tpu_torch.parallel import mesh as mesh_lib
from pointcloudprocessing_tpu_torch.train import steps as steps_lib
from pointcloudprocessing_tpu_torch.utils.device import require_device

NUM_CLASSES = 23
NUM_PARTS = 12

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RANK_TIMEOUT_S = 600
_RANK_MAIN = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from pointcloudprocessing_tpu_torch.graft_entry import _dryrun_rank\n"
    "_dryrun_rank(*sys.argv[2:])\n"
)


def entry(device="cuda") -> tuple[Callable, tuple]:
    """(fn, example_args) of one eval-mode PointNet step on ``device``."""
    device = require_device(device)
    model = PointNet(NUM_CLASSES, NUM_PARTS,
                     generator=torch.Generator().manual_seed(0),
                     device=device).eval()
    points = torch.zeros((8, 1024, 3), dtype=torch.float32, device=device)

    @torch.no_grad()
    def forward(state: dict[str, torch.Tensor], points: torch.Tensor):
        return functional_call(model, state, (points,))

    return forward, (dict(model.state_dict()), points)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the three legs over ``n_devices`` gloo ranks on ``device`` ("cuda":
    rank r on card r mod the card count; "cpu"); prints rank 0's lines and
    raises if any rank fails."""
    device = require_device(device)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_MAIN, _ROOT, str(rank), str(n_devices),
         str(port), device.type],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n_devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sys.stdout.write(outs[0][0])
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed or "dryrun_multichip OK" not in outs[0][0]:
        raise RuntimeError(
            f"dryrun_multichip: ranks {failed} failed:\n"
            + "\n".join(f"rank {r}:\n{outs[r][1][-3000:]}" for r in failed or [0]))


def _dryrun_rank(rank: str, world: str, port: str, kind: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        _legs(rank, world, kind)
    finally:
        dist.destroy_process_group()


def _rank_device(kind: str, rank: int) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _legs(rank: int, world: int, kind: str) -> None:
    from pointcloudprocessing_tpu_torch.models.pipeline import PointCloudPipeline

    mesh = mesh_lib.data_parallel_mesh(_rank_device(kind, rank))
    say = print if rank == 0 else (lambda *a, **k: None)
    # the JAX dry run's shapes: a data x points plan where n allows, whose
    # points axis the port's uneven rows stand in for
    points_axis = 2 if (world % 2 == 0 and world >= 4) else 1
    plan = ({"data": world // points_axis, "points": points_axis}
            if points_axis > 1 else {"data": world})
    batch, width = 4 * (world // points_axis), 128 * points_axis
    rng = np.random.default_rng(0)  # the same draws on every rank

    def targets(b):
        return {
            "classification_output": rng.integers(0, NUM_CLASSES, b),
            "segmentation_output": rng.integers(0, NUM_PARTS, (b, width)),
            "se3": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        }

    def model_state(seed):
        model = PointNet(NUM_CLASSES, NUM_PARTS,
                         generator=torch.Generator().manual_seed(seed),
                         device=mesh.device)
        freeze = FreezeFlags(segmentation_head=True)  # curriculum stage 1
        state, optimizer = steps_lib.init_train_state(
            model, LearningConfig(rate=1e-3), freeze)
        return model, mesh_lib.shard_train_state(state, mesh), optimizer, freeze

    # ---- leg 1: the global-mode train step (GSPMD's counterpart)
    model, state, optimizer, freeze = model_state(0)
    mesh_lib.sync_batch_stats(model, mesh)
    step = steps_lib.make_train_step(model, optimizer, (1.0, 0.0, 0.1), freeze,
                                     (0.01, 0.01, 0.01), mesh)
    x = rng.normal(size=(batch, width, 3)).astype(np.float32)
    xs, ts = mesh_lib.shard_batch((x, targets(batch)), mesh)
    state, logs = step(state, xs, ts, 1)
    loss = float(logs["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"leg 1: non-finite loss {loss}")
    rows = [mesh.rows(batch, r).stop - mesh.rows(batch, r).start for r in range(world)]
    say(f"leg 1 (global train step, the GSPMD counterpart) OK: mesh={mesh.shape()} "
        f"rows={rows} (the JAX plan {plan}) batch={batch} width={width} "
        f"loss={loss:.4f}")

    # ---- leg 2: the shard_map step (per-replica statistics), 2 steps
    sm_model, sm_state, sm_optimizer, freeze = model_state(2)
    sm_step = steps_lib.make_shardmap_train_step(
        sm_model, sm_optimizer, (1.0, 0.0, 0.1), freeze, (0.01, 0.01, 0.01), mesh)
    k_steps, sm_batch = 2, 2 * world
    for _ in range(k_steps):
        xs, ts = mesh_lib.shard_batch(
            (rng.normal(size=(sm_batch, width, 3)).astype(np.float32),
             targets(sm_batch)), mesh)
        sm_state, sm_logs = sm_step(sm_state, xs, ts, 3)
    sm_loss = float(sm_logs["loss"])
    if not np.isfinite(sm_loss):
        raise RuntimeError(f"leg 2: non-finite loss {sm_loss}")
    say(f"leg 2 (shard_map train step, kernels per rank) OK: mesh={mesh.shape()} "
        f"K={k_steps} batch={sm_batch} loss={sm_loss:.4f}")

    # ---- leg 3: sharded serving over an in-process mesh of n devices
    if rank == 0:
        devices = [_rank_device(kind, r) for r in range(world)]
        pipeline = PointCloudPipeline(sm_model, scan_width=width * 2,
                                      model_width=width, voxel_size=0.05,
                                      mesh=devices)
        scans = rng.normal(size=(2 * world, width * 2, 3)).astype(np.float32)
        served = pipeline(scans)
        cls = served["classification_output"]
        if tuple(cls.shape) != (2 * world, NUM_CLASSES) or not bool(
                torch.isfinite(cls).all()):
            raise RuntimeError(f"leg 3: classification {tuple(cls.shape)}")
        if tuple(served["segmentation_output"].shape) != (2 * world, width, NUM_PARTS):
            raise RuntimeError("leg 3: segmentation shape "
                               f"{tuple(served['segmentation_output'].shape)}")
        say(f"leg 3 (sharded serving pipeline: voxel+FPS+model over "
            f"{[str(d) for d in devices]}) OK: batch={2 * world} "
            f"scan_width={width * 2} -> model_width={width}")
    dist.barrier()
    say(f"dryrun_multichip OK: mesh={mesh.shape()} batch={batch} width={width} "
        f"loss={loss:.4f}; legs: global train, shard_map train (kernels per "
        f"rank), sharded serving")

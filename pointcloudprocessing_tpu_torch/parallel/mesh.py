"""Data parallelism over several devices
(``pointcloudprocessing_tpu/parallel/mesh.py``).

The JAX package runs one controller over a device mesh, and GSPMD or
``shard_map`` put in the collectives. The port runs one process a device
under ``torch.distributed`` (``torchrun``, or ranks started with an
address, a world size and a rank) and calls the collectives itself:

- :func:`initialize_multihost` joins the process group: NCCL unless the
  caller asks for gloo (the CPU tests, ranks that share one card).
- :func:`data_parallel_mesh` describes the devices. With a process group it
  is the process-group form (training): this rank's device, the group, the
  rank and the world size. Without one it is the in-process form
  (serving): one process drives a list of devices, repeats allowed, as the
  JAX controller drives its mesh.
- :func:`shard_batch` / :func:`make_global_batch` give a rank its rows of a
  batch; :func:`shard_train_state` / :func:`replicate_from_local`
  broadcast rank 0's parameters, buffers and optimizer state.
- :func:`sync_batch_stats` switches a model's batch-statistics BatchNorms
  (pooled chains included) to statistics over the whole group, in the
  spirit of ``nn.SyncBatchNorm.convert_sync_batchnorm``; ``None`` switches
  them back.
- :class:`RowDraws` draws a random tensor for the whole batch and keeps a
  rank's rows, so jitter and dropout in the global mode are the draws of
  one device on the whole batch.

Rows: rank r of w holds rows ``[r b // w, (r + 1) b // w)`` of a batch of
b, so shares differ by at most one row. Where the device count does not
divide the batch, the JAX package adds a ``points`` mesh axis; the port
splits the rows unevenly instead, which computes the same step (GSPMD's
program is the whole-batch step either way), so ``points_axis`` stays 1.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """Devices of a data-parallel run. Process-group form: ``devices`` is
    this rank's device alone, ``group`` the process group, ``rank`` and
    ``world`` its place in it. In-process form: ``devices`` every device the
    process drives (a shard each), ``group`` None, ``rank`` 0, ``world`` the
    number of devices."""

    devices: tuple[torch.device, ...]
    group: object | None
    rank: int
    world: int

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of the in-process form)."""
        return self.devices[0]

    def rows(self, batch: int, rank: int | None = None) -> slice:
        """Rank ``rank``'s rows (this rank's by default) of a batch."""
        return row_slice(batch, self.rank if rank is None else rank, self.world)

    def shape(self) -> dict[str, int]:
        """The mesh's axes, as the JAX package logs them."""
        return {"data": self.world}


def row_slice(batch: int, rank: int, world: int) -> slice:
    """Rows ``[rank b // world, (rank + 1) b // world)`` of a batch of b."""
    return slice(rank * batch // world, (rank + 1) * batch // world)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> int:
    """Join the process group before any collective; returns the world size.

    Wraps ``torch.distributed.init_process_group``. An argument left None is
    read from the environment ``torchrun`` sets: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. ``backend`` is NCCL unless
    the caller names another ("gloo"); NCCL without CUDA raises. With NCCL
    the rank's current device becomes ``cuda:LOCAL_RANK``.
    """
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "the NCCL backend needs CUDA, and CUDA is not available; pass "
            "backend='gloo' for CPU processes")
    env = os.environ
    try:
        address = coordinator_address or f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        rank = int(env["RANK"]) if process_id is None else process_id
    except KeyError as e:
        raise ValueError(
            f"initialize_multihost: {e.args[0]} is not set; pass the "
            "coordinator address, the number of processes and this process's "
            "id, or start the processes with torchrun") from None
    init = address if "://" in address else f"tcp://{address}"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return dist.get_world_size()


def _local_rank(rank: int) -> int:
    count = max(torch.cuda.device_count(), 1)
    return int(os.environ.get("LOCAL_RANK", rank % count))


def _require(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but CUDA is not available; "
            "name the CPU to run there")
    return device


def data_parallel_mesh(devices=None, points_axis: int = 1) -> DataParallelMesh:
    """The mesh of this process: the process-group form when a process
    group is initialized (``devices``: None for ``cuda:LOCAL_RANK``, or
    this rank's device), else the in-process form over ``devices`` (None:
    every CUDA device). ``points_axis`` other than 1 raises: the port
    splits rows unevenly where the JAX package adds a points axis."""
    if points_axis != 1:
        raise ValueError(
            f"points_axis={points_axis}: the port has no points axis; a batch "
            "the device count does not divide is split into uneven row shares")
    if dist.is_available() and dist.is_initialized():
        if isinstance(devices, (list, tuple)):
            if len(devices) != 1:
                raise ValueError(
                    "a process-group mesh takes this rank's device alone, "
                    f"got {devices}")
            devices = devices[0]
        device = torch.device("cuda" if devices is None else devices)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", _local_rank(dist.get_rank()))
        return DataParallelMesh((_require(device),), dist.group.WORLD,
                                dist.get_rank(), dist.get_world_size())
    return local_mesh(devices)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so that repeats compare equal
    to the devices tensors report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_mesh(devices=None) -> DataParallelMesh:
    """The in-process form over ``devices`` (None: every CUDA device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no devices named and CUDA is not available; name the devices")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(_require(torch.device(d))) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return DataParallelMesh(devices, None, 0, len(devices))


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: DataParallelMesh, rank: int | None = None):
    """Rank ``rank``'s rows (this rank's by default) of a global batch
    (tensors or arrays, nested in dicts, lists and tuples; axis 0 the
    batch) as tensors on that rank's device."""
    rank = mesh.rank if rank is None else rank
    device = mesh.device if mesh.group is not None else mesh.devices[rank]

    def put(x):
        return torch.as_tensor(x[mesh.rows(x.shape[0], rank)]).to(device)

    return _tree_map(put, batch)


def make_global_batch(local_batch, mesh: DataParallelMesh):
    """Multi-process form of :func:`shard_batch`: each rank passes only its
    own rows and gets them on its device. The steps take a rank's rows and
    the collectives make the step global."""
    if mesh.group is None:
        raise ValueError("make_global_batch needs the process-group form; "
                         "the in-process form takes shard_batch")
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), local_batch)


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor of a module (parameters, buffers), a train state (its
    model and optimizer state), or a dict, list or tuple of them."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    return []


@torch.no_grad()
def replicate_from_local(tree, mesh: DataParallelMesh):
    """Overwrite every tensor of ``tree`` (a module, a train state, or a
    dict, list or tuple of tensors) with rank 0's, in place, and return it.
    The in-process form and a group of one leave it as it is."""
    if mesh.group is None or mesh.world == 1:
        return tree
    for t in _tensors(tree):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def shard_train_state(state, mesh: DataParallelMesh):
    """Replicate a train state (model parameters and buffers, optimizer
    state) from rank 0 (:func:`replicate_from_local`)."""
    return replicate_from_local(state, mesh)


def sync_batch_stats(model: torch.nn.Module, mesh: DataParallelMesh | None):
    """Make every batch-statistics BatchNorm of ``model`` (the modules with a
    ``stats_group``: ``layers.BatchNorm``, which pooled chains use too)
    take its statistics over ``mesh``'s group; ``None``, or a mesh without a
    group, restores local statistics. Returns the model."""
    group = None if mesh is None else mesh.group
    for m in model.modules():
        if hasattr(m, "stats_group"):
            m.stats_group = group
    return model


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the group, differentiable: its gradient is
    the sum of the ranks' upstream gradients (each rank's output feeds
    every rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_moments(x: torch.Tensor, axes: tuple[int, ...], group):
    """Mean and biased variance of x over ``axes`` and every rank's rows:
    ``[sum x, sum x^2, count]`` summed over the group (the counts weight
    uneven row shares exactly), then ``E[x^2] - E[x]^2`` clamped at 0."""
    c = x.shape[-1]
    count = x.new_full((1,), float(x.numel() // c))
    total = _AllReduceSum.apply(
        torch.cat([x.sum(dim=axes), torch.square(x).sum(dim=axes), count]), group)
    mean = total[:c] / total[-1]
    var = torch.clamp(total[c:2 * c] / total[-1] - torch.square(mean), min=0.0)
    return mean, var


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """A generator whose draws cover the whole batch (``batch`` rows), of
    which a rank keeps ``rows`` (a slice, or any index of rows): the global
    mode's jitter and dropout are then the single-device step's on the
    whole batch."""

    generator: torch.Generator
    batch: int
    rows: slice | torch.Tensor


def draw(fn: Callable, shape, generator, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=generator, **kwargs)`` (``torch.rand`` or
    ``torch.randn``); for :class:`RowDraws`, the draw over the whole batch
    and then this rank's rows."""
    if isinstance(generator, RowDraws):
        full = fn((generator.batch, *shape[1:]), generator=generator.generator,
                  **kwargs)
        return full[generator.rows]
    return fn(shape, generator=generator, **kwargs)

"""One PointNet++ set-abstraction level in inference: the hand-written CUDA
kernel and its plain version.

A level gathers each group's k neighbour rows (centered coordinates ++
neighbour features), runs three pointwise layers, each a product, its
BatchNorm with running statistics and relu, and takes the max over the
group's rows. No TPU kernel does this: the JAX package leaves the grouped
MLP to XLA. The kernel (``csrc/sa_group_mlp.cu``) does it in one launch
with the BatchNorm folded into an affine, ``a = scale * rsqrt(running_var +
eps)``, ``c = bias - running_mean * a``, so no (b, m, k, c) activation is
written (the source says how). The plain version repeats that arithmetic in
tensor code.

:func:`sa_group_mlp` is the route: a CUDA tensor goes to the kernel, and any
shape the kernel does not take raises; a CPU tensor takes the plain
version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from pointcloudprocessing_tpu_torch.ops.cuda import build
from pointcloudprocessing_tpu_torch.ops.gather import gather_rows

#: a layer: (weight (c_out, c_in), BatchNorm scale, bias, running mean,
#: running variance), each f32
Layer = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: the widths the kernel takes: multiples of 64 up to 256 (the input's
#: features too, or none), k up to 64, three layers
WIDTH_STEP, MAX_WIDTH, MAX_K, DEPTH = 64, 256, 64, 3
#: the kernel's shared memory a block (``csrc/sa_group_mlp.cu``): two
#: activation regions of a tile's rows, the ring of split weight stages, the
#: tile's coordinates, the folded affine, the group slots and the stages'
#: barriers, in floats
_STAGES, _SLICE, _CHUNK, _MAX_GROUPS = 4, 64, 32, 16
_SMEM_LIMIT = 232448


def sa_group_mlp_reference(xyz: torch.Tensor, feats: Optional[torch.Tensor],
                           centers: torch.Tensor, idx: torch.Tensor,
                           layers: Sequence[Layer], eps: float) -> torch.Tensor:
    """Plain version: gather and center, then each layer as ``relu(a * (x @
    w^T) + c)`` with the BatchNorm folded as the kernel folds it, ``a =
    scale * rsqrt(var + eps)``, ``c = bias - mean * a``, then the max over
    each group. xyz (b, n, 3), feats (b, n, f) or None, centers (b, m, 3),
    idx (b, m, k) -> (b, m, c_out)."""
    x = gather_rows(xyz, idx) - centers[:, :, None, :]
    if feats is not None:
        x = torch.cat([x, gather_rows(feats, idx)], dim=-1)
    for weight, scale, bias, mean, var in layers:
        a = scale * torch.rsqrt(var + eps)
        c = torch.addcmul(bias, mean, a, value=-1.0)
        x = torch.relu(F.linear(x, weight) * a + c)
    return x.amax(dim=2)


def _stride(f: int, c1: int, c2: int) -> int:
    return max(f, c1, c2) + 4


def smem_bytes(rows: int, f: int, c1: int, c2: int) -> int:
    """Shared memory of a block of the kernel at ``rows`` a tile."""
    floats = (2 * rows * _stride(f, c1, c2) + _STAGES * 2 * _SLICE * _CHUNK
              + 2 * rows * 4 + 2 * _MAX_GROUPS * 4 + MAX_WIDTH * 4 + 2 * 3 * MAX_WIDTH
              + _MAX_GROUPS * _SLICE + 2 * _STAGES)
    return 4 * floats


def tile_rows(f: int, c1: int, c2: int) -> int:
    """Rows of a tile: 128 where a block's shared memory holds them, else 64."""
    return 128 if smem_bytes(128, f, c1, c2) <= _SMEM_LIMIT else 64


def split_floats(f: int, c1: int, c2: int, c3: int) -> int:
    """The kernel's scratch: every 64-column x 32-channel weight stage of a
    tile's steps, split into hi and lo (a first launch of the call writes it,
    a block a stage)."""
    return (f * c1 + c1 * c2 + c2 * c3) // (_SLICE * _CHUNK) * 2 * _SLICE * _CHUNK


def _check_width(what: str, c: int) -> None:
    if not (WIDTH_STEP <= c <= MAX_WIDTH and c % WIDTH_STEP == 0):
        raise ValueError(
            f"the SA kernel takes widths that are multiples of {WIDTH_STEP} up to "
            f"{MAX_WIDTH}, got {what} {c}")


def _check(xyz, feats, centers, idx, layers) -> tuple[int, int, int, int, int]:
    """Refuse what the kernel does not take, on any device: returns (b, n,
    m, k, f)."""
    if len(layers) != DEPTH:
        raise ValueError(f"the SA kernel takes {DEPTH} layers, got {len(layers)}")
    tensors = [xyz, centers, *(t for layer in layers for t in layer)]
    if feats is not None:
        tensors.append(feats)
    for tensor in tensors:
        if tensor.dtype != torch.float32:
            raise TypeError(f"the SA kernel takes f32 tensors, got {tensor.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"the SA kernel takes int32 neighbour indices, got {idx.dtype}")
    if not all(t.is_contiguous() for t in (*tensors, idx)):
        raise ValueError("the SA kernel needs contiguous tensors")
    if any(t.device != xyz.device for t in (*tensors, idx)):
        raise ValueError("the SA kernel needs every tensor on one device")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or centers.dim() != 3 or idx.dim() != 3:
        raise ValueError("the SA kernel takes xyz (b, n, 3), centers (b, m, 3) and idx "
                         f"(b, m, k), got {tuple(xyz.shape)}, {tuple(centers.shape)}, "
                         f"{tuple(idx.shape)}")
    b, n, _ = xyz.shape
    m, k = idx.shape[1], idx.shape[2]
    if tuple(centers.shape) != (b, m, 3) or idx.shape[0] != b or n < 1:
        raise ValueError(f"centers {tuple(centers.shape)} and idx {tuple(idx.shape)} do "
                         f"not match xyz {tuple(xyz.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the SA kernel takes 1 <= k <= {MAX_K}, got k {k}")
    f = 0
    if feats is not None:
        if feats.dim() != 3 or tuple(feats.shape[:2]) != (b, n):
            raise ValueError(f"feats {tuple(feats.shape)} do not match xyz {tuple(xyz.shape)}")
        f = feats.shape[-1]
        _check_width("feature channels", f)
    c_in = 3 + f
    for i, (weight, *bn) in enumerate(layers):
        if weight.dim() != 2 or weight.shape[1] != c_in:
            raise ValueError(f"layer {i + 1}'s weight {tuple(weight.shape)} does not take "
                             f"{c_in} channels")
        c_in = weight.shape[0]
        _check_width(f"layer {i + 1}'s width", c_in)
        if any(tuple(t.shape) != (c_in,) for t in bn):
            raise ValueError(f"layer {i + 1}'s BatchNorm is not of {c_in} channels")
    return b, n, m, k, f


def sa_group_mlp(xyz: torch.Tensor, feats: Optional[torch.Tensor],
                 centers: torch.Tensor, idx: torch.Tensor,
                 layers: Sequence[Layer], eps: float) -> torch.Tensor:
    """A set-abstraction level's grouped MLP and group max: xyz (b, n, 3),
    feats (b, n, f) or None, centers (b, m, 3), idx (b, m, k) int32 in [0,
    n), three layers -> (b, m, c_out) f32. A CUDA tensor takes the kernel
    (widths multiples of 64 up to 256, f 0 or such a width, k up to 64);
    a CPU tensor the plain version. No host sync."""
    b, n, m, k, f = _check(xyz, feats, centers, idx, layers)
    if xyz.device.type == "cpu":
        return sa_group_mlp_reference(xyz, feats, centers, idx, layers, eps)
    if xyz.device.type != "cuda":
        raise ValueError(f"no SA kernel for device {xyz.device}")
    c1, c2, c3 = (layer[0].shape[0] for layer in layers)
    out = torch.empty((b, m, c3), dtype=torch.float32, device=xyz.device)
    split = torch.empty(split_floats(f, c1, c2, c3), dtype=torch.float32, device=xyz.device)
    ptrs = [xyz.data_ptr(), None if feats is None else feats.data_ptr(),
            centers.data_ptr(), idx.data_ptr()]
    # the weights, then the scales, biases, running means and variances
    ptrs += [layer[part].data_ptr() for part in range(5) for layer in layers]
    build.launch("pcp_sa_group_mlp", xyz.device, *ptrs, out.data_ptr(), split.data_ptr(),
                 b, n, m, k, f, c1, c2, c3, tile_rows(f, c1, c2), build.sms(xyz.device), eps)
    build.count("sa_group_mlp")
    return out

"""Seeded weights for a model's ``state_dict`` names, made on the device in
one draw: Glorot-uniform dense kernels, small uniform biases, BatchNorm
scales, shifts and running statistics in ranges a trained network has, and
the T-Nets' identity biases. The benchmark loads the same tensors into the
program and hands them to the reference."""

from __future__ import annotations

import math

import numpy as np
import torch

#: the uniform range of each kind of leaf, by its name's ending
RANGES = {
    ".bn.weight": (0.5, 1.5),
    ".bn.bias": (-0.2, 0.2),
    ".bn.running_mean": (-0.2, 0.2),
    ".bn.running_var": (0.5, 2.0),
    ".bias": (-0.1, 0.1),
}


def _range(name: str, shape: tuple) -> tuple[float, float] | None:
    for ending, bounds in RANGES.items():
        if name.endswith(ending):
            return bounds
    if len(shape) == 2 and name.endswith(".b") and shape[0] == shape[1]:
        return None  # a T-Net's bias: the identity
    if len(shape) == 2:  # a dense kernel, (out, in) or a T-Net's (in, k * k)
        fan_out, fan_in = shape if name.endswith(".weight") else shape[::-1]
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return (-limit, limit)
    raise ValueError(f"no rule for the weight {name!r} of shape {shape}")


def make_weights(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: shape} -> {name: f32 tensor on ``device``} from ``seed``."""
    g = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 0x77656967]).generate_state(1)[0]))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=g, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        bounds = _range(name, tuple(shape))
        if bounds is None:
            out[name] = torch.eye(shape[0], dtype=torch.float32, device=device)
        else:
            lo, hi = bounds
            out[name] = (lo + (hi - lo) * flat[at:at + size]).reshape(shape)
        at += size
    return out

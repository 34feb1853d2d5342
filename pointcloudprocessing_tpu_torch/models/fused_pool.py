"""``dense -> BatchNorm -> relu -> global max-pool`` over points
(``pointcloudprocessing_tpu/models/fused_pool.py``), inference form.

With running statistics the JAX package takes its jnp formulation
(``fused_pool.py:120-144``), not a kernel, so this is plain PyTorch in the
same operation order. The batch-statistics forward and the custom backward
(the pooled-chain kernels) belong to the training port (ROADMAP queue 1
item 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_bn_relu_max(
    x: torch.Tensor,
    weight: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """x (b, n, c_in), weight (c, c_in) -> pooled (b, c), using the running
    BatchNorm statistics."""
    pre = F.linear(x, weight)  # (b, n, c)
    xhat = (pre - running_mean) * torch.rsqrt(running_var + eps)
    y = xhat * scale + bias
    return torch.relu(y).amax(dim=1)

"""``dense -> BatchNorm -> relu -> global max-pool`` over points with a
custom backward (``pointcloudprocessing_tpu/models/fused_pool.py``).

Only one point per (cloud, channel), the argmax winner, receives gradient
through the pool, and the dense part of the BatchNorm backward factors
through the matmul:

    dpre = s * (dy - mean(dy) - xhat * mean(dy * xhat)),  s = gamma / sigma
    dx   = [winner-sparse term] @ W  +  x @ (W^T diag(q) W)  +  const_row

so neither direction writes a (b, n, c) gradient.

Batch statistics (train mode, not frozen) come from the Gram matrix:
``E[pre] = (1^T x) W^T / N`` and ``E[pre^2] = diag(W (x^T x) W^T) / N``, so
no (b, n, c) activation is written either; the variance is not clamped at 0,
as in the JAX package. The chain then runs through the pooled-chain kernels
(``ops/cuda/pooled_chain.py``) in f32, forward and backward. This differs on
purpose from the JAX package, which takes its kernels only in bf16: its
packed argmax rounds the pooled value, so its f32 mode keeps the jnp path.
The port's forward kernel is exact in f32, so on CUDA every batch-statistics
chain goes through both kernels: both T-Nets' ``conv_layer_3`` and the
trunk's ``mlp_2_3``, each with c_in = 128 and c = 1024. On the CPU the same
code runs the kernels' plain versions.

With running statistics the forward is plain PyTorch in the JAX package's
operation order (it takes no kernel there either), and the backward is the
JAX package's running-statistics branch: the winners' gradient alone, which
is the backward kernel with a zero dense term (m = 0, row = 0). A training
step reaches it only when a frozen chain sits below a trained parameter
(the trunk frozen under a trained input T-Net): ``init_train_state`` turns
``requires_grad`` off on frozen parameters, so a frozen input T-Net, which
only raw points feed, runs without autograd.

The (c_in, c_in) products ``x^T x`` and ``W (x^T x) W^T`` are
``torch.matmul`` outside the kernels; the JAX package pins them to full f32
precision, so TF32 must stay off (it is off by default for matmuls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointcloudprocessing_tpu_torch.ops.cuda.pooled_chain import (
    pooled_chain_backward,
    pooled_chain_forward,
)


def _winner_xhat(pooled, scale, bias):
    """The winners' normalized value, rebuilt from the pooled output: y_w =
    pooled wherever pooled > 0, and the backward gates on pooled > 0, so the
    value where pooled == 0 (or gamma == 0) is never used."""
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return torch.where(scale == 0.0, torch.zeros_like(scale), (pooled - bias) / safe)


class _BatchStatsChain(torch.autograd.Function):
    """Batch-statistics chain: Gram-matrix statistics and both kernels."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias, eps):
        b, n, c_in = x.shape
        num = b * n
        x2 = x.reshape(num, c_in)
        xsum = x2.sum(dim=0)
        gram = torch.matmul(x2.t(), x2)  # (c_in, c_in)
        kf = weight.t()  # the Flax kernel (c_in, c)
        gw = torch.matmul(gram, kf)
        mean = torch.matmul(xsum, kf) / num
        var = (gw * kf).sum(dim=0) / num - torch.square(mean)
        inv = torch.rsqrt(var + eps)
        a = scale * inv
        c_row = bias - mean * a
        pooled, argmax = pooled_chain_forward(
            x, weight, a.contiguous(), c_row.contiguous())
        xhat_w = _winner_xhat(pooled, scale, bias)
        ctx.save_for_backward(x, weight, scale, pooled, mean, var, argmax,
                              xhat_w, xsum, gram)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        (x, weight, scale, pooled, mean, var, argmax, xhat_w, xsum,
         gram) = ctx.saved_tensors
        b, n, _ = x.shape
        num = b * n
        kernel = weight.t()  # (c_in, c)
        inv = torch.rsqrt(var + ctx.eps)
        s = scale * inv
        # gradient reaches only the winners; relu gate: pooled > 0 <=> y_w > 0
        dy_w = g_out * (pooled > 0)
        dbias = dy_w.sum(dim=0)
        dscale = (dy_w * xhat_w).sum(dim=0)
        coef = dy_w * s
        sum1, sum2 = dbias, dscale
        # dense batch-statistics term D = -(1/N) s (sum1 + xhat sum2),
        # factored through the matmul: D @ W = x @ m_small + const_row
        q = -(s * sum2 * inv) / num
        m_small = torch.matmul(kernel * q[None, :], kernel.t())
        const_row = torch.matmul(
            -(s * sum1) / num + mean * inv * s * sum2 / num, kernel.t())
        dx, dk_sparse = pooled_chain_backward(
            x, weight, coef.contiguous(), argmax, m_small.contiguous(),
            const_row.contiguous())
        # dW dense part: x^T D = -(1/N) [ (x^T 1)(s sum1)^T
        #                 + (x^T x W - (x^T 1) mu^T) diag(inv s sum2) ]
        dk_dense = -(
            torch.outer(xsum, s * sum1)
            + (torch.matmul(gram, kernel) - torch.outer(xsum, mean))
            * (inv * s * sum2)[None, :]
        ) / num
        dweight = (dk_sparse + dk_dense).t()
        return dx, dweight, dscale, dbias, None


class _RunningStatsChain(torch.autograd.Function):
    """Running-statistics chain with the winner-only backward."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias, running_mean, running_var, eps):
        pre = F.linear(x, weight)
        inv = torch.rsqrt(running_var + eps)
        xhat = (pre - running_mean) * inv
        r = torch.relu(xhat * scale + bias)
        pooled = r.amax(dim=1)
        argmax = r.argmax(dim=1)
        xhat_w = xhat.gather(1, argmax[:, None, :]).squeeze(1)
        ctx.save_for_backward(x, weight, scale, pooled, inv, argmax.int(), xhat_w)
        return pooled

    @staticmethod
    def backward(ctx, g_out):
        x, weight, scale, pooled, inv, argmax, xhat_w = ctx.saved_tensors
        c_in = x.shape[-1]
        dy_w = g_out * (pooled > 0)
        dx, dk = pooled_chain_backward(
            x, weight, (dy_w * (scale * inv)).contiguous(), argmax,
            x.new_zeros((c_in, c_in)), x.new_zeros(c_in))
        return (dx, dk.t(), (dy_w * xhat_w).sum(dim=0), dy_w.sum(dim=0),
                None, None, None)


def dense_bn_relu_max(
    x: torch.Tensor,
    weight: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float,
    use_running: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (b, n, c_in), weight (c, c_in) -> (pooled (b, c), batch_mean,
    batch_var). With ``use_running`` the running statistics normalize and
    come back unchanged; otherwise the batch's own statistics do, and the
    caller updates its running statistics from the returned ones."""
    if not use_running:
        return _BatchStatsChain.apply(x, weight, scale, bias, eps)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, scale, bias)):
        pooled = _RunningStatsChain.apply(
            x, weight, scale, bias, running_mean, running_var, eps)
    else:  # inference: no winner bookkeeping
        pre = F.linear(x, weight)
        xhat = (pre - running_mean) * torch.rsqrt(running_var + eps)
        pooled = torch.relu(xhat * scale + bias).amax(dim=1)
    return pooled, running_mean, running_var

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

With running statistics and no gradient to keep (inference, or a frozen
chain that nothing trained feeds), an f32 chain on a CUDA tensor takes the
forward kernel alone, with the running statistics folded into its affine
(``a = scale / sqrt(running_var + eps)``, ``c_row = bias - running_mean *
a``), so no (b, n, c) activation is written. Every width the kernel does
not take raises there, as in training. The JAX package takes no kernel
there (its f32 chains keep the jnp path); the port's forward kernel is
exact in f32, as above. On the CPU, and in bf16, the forward is plain
PyTorch in the JAX package's operation order: the CPU keeps the JAX
package's numbers for the parity tests and ``export/pt2.py``'s trace, and
bf16 rounds each step as the jnp branch does (below), which the bf16
kernel does not reproduce.

With running statistics and a gradient to keep, the forward is that plain
one and the backward is the JAX package's running-statistics branch: the
winners' gradient alone, which is the backward kernel with a zero dense
term (m = 0, row = 0). A training step reaches it only when a frozen chain
sits below a trained parameter (the trunk frozen under a trained input
T-Net): ``init_train_state`` turns ``requires_grad`` off on frozen
parameters, so a frozen input T-Net, which only raw points feed, runs
without autograd, and takes the kernel.

Over a process group (``parallel.mesh.sync_batch_stats``, the global
training mode) the forward sums ``x^T 1``, ``x^T x`` and the row count over
the ranks before the statistics, so the kernels run on each rank's rows
with the global affine; the backward sums the two statistics terms
(``sum1``, ``sum2``) over the ranks for the dense term and returns this
rank's share of the parameters' gradients. The JAX package's GSPMD mode
drops its Pallas chains only because GSPMD cannot partition a custom call;
the function is the same, so the port keeps its kernels there.

The (c_in, c_in) products ``x^T x`` and ``W (x^T x) W^T`` are
``torch.matmul`` outside the kernels; the JAX package pins them to full f32
precision, so TF32 must stay off (it is off by default for matmuls).

``dtype=torch.bfloat16`` follows the JAX package's bf16 chain. With batch
statistics it is the branch that takes its Pallas kernels: x and the
weight go to the kernels' bf16 forms, the Gram matrix and x-sum are summed
in f32 from the bf16 x, the statistics use the f32 weight, the affine
stays f32, and dx comes back in bf16. With running statistics it is the
jnp branch, which rounds each step to bf16 (the pre-activation, the
normalizing scale, the affine), and whose backward rounds dk to bf16.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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
    """Batch-statistics chain: Gram-matrix statistics and both kernels, in
    f32 or (``dtype``) on the kernels' bf16 forms."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias, eps, dtype, group):
        in_dtype = x.dtype
        if dtype is not None:
            x = x.to(dtype)
        b, n, c_in = x.shape
        num = b * n
        x2 = x.reshape(num, c_in).float()
        xsum = x2.sum(dim=0)
        gram = torch.matmul(x2.t(), x2)  # (c_in, c_in)
        xsum_g, gram_g = xsum, gram
        if group is not None:  # the statistics of every rank's rows
            total = torch.cat([xsum, gram.reshape(-1), xsum.new_full((1,), num)])
            dist.all_reduce(total, group=group)
            xsum_g, gram_g = total[:c_in], total[c_in:-1].reshape(c_in, c_in)
            num = total[-1]
        kf = weight.t()  # the Flax kernel (c_in, c)
        gw = torch.matmul(gram_g, kf)
        mean = torch.matmul(xsum_g, kf) / num
        var = (gw * kf).sum(dim=0) / num - torch.square(mean)
        inv = torch.rsqrt(var + eps)
        a = scale * inv
        c_row = bias - mean * a
        w_op = weight if dtype is None else weight.to(dtype)
        pooled, argmax = pooled_chain_forward(
            x, w_op, a.contiguous(), c_row.contiguous())
        xhat_w = _winner_xhat(pooled, scale, bias)
        ctx.save_for_backward(x, weight, w_op, scale, pooled, mean, var,
                              argmax, xhat_w, xsum, gram)
        ctx.eps, ctx.in_dtype, ctx.num, ctx.group = eps, in_dtype, num, group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g_out, _g_mean, _g_var):
        (x, weight, w_op, scale, pooled, mean, var, argmax, xhat_w, xsum,
         gram) = ctx.saved_tensors
        num = ctx.num
        kernel = weight.t()  # (c_in, c)
        inv = torch.rsqrt(var + ctx.eps)
        s = scale * inv
        # gradient reaches only the winners; relu gate: pooled > 0 <=> y_w > 0
        dy_w = g_out * (pooled > 0)
        dbias = dy_w.sum(dim=0)
        dscale = (dy_w * xhat_w).sum(dim=0)
        coef = dy_w * s
        sum1, sum2 = dbias, dscale
        if ctx.group is not None:
            # the statistics' gradient terms sum over every rank's rows; the
            # parameters' gradients stay this rank's share (dscale, dbias
            # and dweight below), which the step's all-reduce sums once
            sums = torch.cat([dbias, dscale])
            dist.all_reduce(sums, group=ctx.group)
            sum1, sum2 = sums.chunk(2)
        # dense batch-statistics term D = -(1/N) s (sum1 + xhat sum2),
        # factored through the matmul: D @ W = x @ m_small + const_row
        q = -(s * sum2 * inv) / num
        m_small = torch.matmul(kernel * q[None, :], kernel.t())
        const_row = torch.matmul(
            -(s * sum1) / num + mean * inv * s * sum2 / num, kernel.t())
        dx, dk_sparse = pooled_chain_backward(
            x, w_op, coef.contiguous(), argmax, m_small.contiguous(),
            const_row.contiguous())
        # dW dense part over this rank's rows: x^T D = -(1/N) [ (x^T 1)(s sum1)^T
        #                 + (x^T x W - (x^T 1) mu^T) diag(inv s sum2) ]
        dk_dense = -(
            torch.outer(xsum, s * sum1)
            + (torch.matmul(gram, kernel) - torch.outer(xsum, mean))
            * (inv * s * sum2)[None, :]
        ) / num
        dweight = (dk_sparse + dk_dense).t()
        return dx.to(ctx.in_dtype), dweight, dscale, dbias, None, None, None


def _inference_kernel(device: torch.device, x_dtype: torch.dtype,
                      dtype: torch.dtype | None) -> bool:
    """Whether a running-statistics chain with no gradient to keep takes
    the forward kernel: on CUDA, computed in f32 (``dtype`` None, x f32)."""
    return device.type == "cuda" and dtype is None and x_dtype == torch.float32


def _running_forward(x, weight, scale, bias, running_mean, running_var, eps,
                     dtype):
    """The running-statistics chain's forward in the JAX package's operation
    order, each step in ``dtype`` (None: x's): (relu output r, xhat)."""
    cd = dtype or x.dtype
    pre = F.linear(x.to(cd), weight.to(cd))
    inv = torch.rsqrt((running_var + eps).to(cd))
    xhat = (pre - running_mean.to(cd)) * inv
    return torch.relu(xhat * scale.to(cd) + bias.to(cd)), xhat


class _RunningStatsChain(torch.autograd.Function):
    """Running-statistics chain with the winner-only backward."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias, running_mean, running_var, eps,
                dtype):
        r, xhat = _running_forward(x, weight, scale, bias, running_mean,
                                   running_var, eps, dtype)
        pooled = r.amax(dim=1).float()
        argmax = r.argmax(dim=1)
        xhat_w = xhat.gather(1, argmax[:, None, :]).squeeze(1).float()
        inv = torch.rsqrt(running_var + eps)  # f32, as the JAX backward's
        x_op = x if dtype is None else x.to(dtype)
        ctx.save_for_backward(x_op, weight, scale, pooled, inv, argmax.int(),
                              xhat_w)
        ctx.dtype, ctx.in_dtype = dtype, x.dtype
        return pooled

    @staticmethod
    def backward(ctx, g_out):
        x, weight, scale, pooled, inv, argmax, xhat_w = ctx.saved_tensors
        c_in = x.shape[-1]
        dy_w = g_out * (pooled > 0)
        w_op = weight if ctx.dtype is None else weight.to(ctx.dtype)
        dx, dk = pooled_chain_backward(
            x, w_op, (dy_w * (scale * inv)).contiguous(), argmax,
            x.new_zeros((c_in, c_in), dtype=torch.float32),
            x.new_zeros(c_in, dtype=torch.float32))
        if ctx.dtype is not None:  # the JAX einsum's bf16 result
            dk = dk.to(ctx.dtype).float()
        return (dx.to(ctx.in_dtype), dk.t(), (dy_w * xhat_w).sum(dim=0),
                dy_w.sum(dim=0), None, None, None, None)


def dense_bn_relu_max(
    x: torch.Tensor,
    weight: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float,
    use_running: bool = True,
    dtype: torch.dtype | None = None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (b, n, c_in), weight (c, c_in) -> (pooled (b, c) f32, batch_mean,
    batch_var), computed in ``dtype`` (None: f32; or bf16). With
    ``use_running`` the running statistics normalize and come back
    unchanged; otherwise the batch's own statistics do (over every rank of
    the process group ``group`` where one is given), and the caller
    updates its running statistics from the returned ones."""
    if not use_running:
        return _BatchStatsChain.apply(x, weight, scale, bias, eps, dtype, group)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, scale, bias)):
        pooled = _RunningStatsChain.apply(
            x, weight, scale, bias, running_mean, running_var, eps, dtype)
    elif _inference_kernel(x.device, x.dtype, dtype):
        a = scale * torch.rsqrt(running_var + eps)
        c_row = torch.addcmul(bias, running_mean, a, value=-1.0)
        pooled, _ = pooled_chain_forward(x, weight, a, c_row)
    else:  # CPU or bf16 inference: no winner bookkeeping
        r, _ = _running_forward(x, weight, scale, bias, running_mean,
                                running_var, eps, dtype)
        pooled = r.amax(dim=1).float()
    return pooled, running_mean, running_var

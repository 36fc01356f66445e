"""Synchronized BatchNorm for torch models (``hvd.SyncBatchNorm``).

Port of the JAX package's ``torch/sync_batch_norm.py`` (reference:
horovod/torch/sync_batch_norm.py): a ``_BatchNorm`` with torch's semantics
(momentum 0.1, the unbiased variance fed to the running statistics,
``momentum=None`` a cumulative average) whose forward allreduces the batch
statistics and whose backward allreduces ``sum_dy`` and ``sum_dy_xmu``.

The port's ranks are GPUs, each with its own data, so the world is the
set's ranks (the JAX bridge counts hosts, ``cross_size()``). Each rank's
statistics are weighted by its element count, which rides one extra element
of the same allreduce, as the reference's ``batch_norm_gather_stats_with_
counts`` weights them: ranks may hold batches of different sizes, and with
equal ones this is the JAX package's average. Both collectives are exact
sums on the set's group (``ops/sync_batch_norm.py::allreduce_``), issued on
the caller's stream after the fusion runtime's buckets in flight; the
statistics never ride the quantized wire. Training always takes the
synchronized path, at one rank too.
"""

import torch
from torch.autograd.function import Function
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch.ops.sync_batch_norm import allreduce_


class SyncBatchNorm(_BatchNorm):
    """BatchNorm with cross-rank statistics (reference:
    torch/sync_batch_norm.py SyncBatchNorm). During training the batch
    statistics are those of every rank's batch together; eval uses the
    running statistics as usual."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.process_set = process_set

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        self._check_input_dim(input)
        momentum = self.momentum
        if self.training and self.track_running_stats:
            if self.num_batches_tracked is not None:
                self.num_batches_tracked.add_(1)
                if momentum is None:
                    # Cumulative moving average, the _BatchNorm contract for
                    # momentum=None.
                    momentum = 1.0 / float(self.num_batches_tracked)

        if not self.training and self.track_running_stats:
            return torch.nn.functional.batch_norm(
                input, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        # Training — or eval without running stats, where _BatchNorm
        # normalizes with (synced) batch statistics.
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias,
            self.running_mean if self.training else None,
            self.running_var if self.training else None,
            self.eps, momentum, self.process_set)


class _SyncBatchNormFn(Function):
    """reference: torch/sync_batch_norm.py _SyncBatchNorm Function."""

    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum, process_set):
        x = input.contiguous()
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = x.numel() // c
        xf = x.float()
        # [count * mean, count * mean(x^2), count]: one sum over the set
        # gives the count-weighted global moments and the global count.
        stats = torch.cat([xf.sum(dim=dims), xf.square().sum(dim=dims),
                           xf.new_full((1,), float(count))])
        allreduce_(stats, process_set)
        total = stats[-1]
        mean = stats[:c] / total
        var = stats[c:2 * c] / total - mean * mean
        invstd = torch.rsqrt(var + eps)
        if running_mean is not None:
            unbiased = var * (total / torch.clamp_min(total - 1, 1))
            running_mean.mul_(1 - momentum).add_(
                momentum * mean.to(running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * unbiased.to(running_var.dtype))

        shape = [1, -1] + [1] * (x.dim() - 2)
        out = (xf - mean.reshape(shape)) * invstd.reshape(shape)
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        ctx.save_for_backward(x, weight, mean, invstd, total)
        ctx.process_set = process_set
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        x, weight, mean, invstd, total = ctx.saved_tensors
        c = x.shape[1]
        g = grad_output.contiguous().float()
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)

        xmu = x.float() - mean.reshape(shape)
        sum_dy = g.sum(dim=dims)
        sum_dy_xmu = (g * xmu).sum(dim=dims)
        # The two reduction terms are means over the global batch
        # (reference: backward allreduces sum_dy/sum_dy_xmu, then divides
        # by the global count).
        red = allreduce_(torch.cat([sum_dy, sum_dy_xmu]), ctx.process_set)
        mean_dy = red[:c] / total
        mean_dy_xmu = red[c:] / total

        gamma = weight.float() if weight is not None \
            else torch.ones_like(mean)
        grad_input = (
            g - mean_dy.reshape(shape)
            - xmu * (invstd * invstd * mean_dy_xmu).reshape(shape)
        ) * (invstd * gamma).reshape(shape)

        grad_weight = None
        if weight is not None and ctx.needs_input_grad[1]:
            grad_weight = (g * xmu * invstd.reshape(shape)).sum(
                dim=dims).to(weight.dtype)
        grad_bias = None
        if ctx.needs_input_grad[2]:
            grad_bias = sum_dy.to(x.dtype)

        return grad_input.to(x.dtype), grad_weight, grad_bias, None, None, \
            None, None, None

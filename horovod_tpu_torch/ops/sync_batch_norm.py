"""Cross-rank synchronized batch normalization, the model-side module.

Port of the JAX package's ``ops/sync_batch_norm.py`` (a Flax module whose
statistics are ``lax.pmean``'d over the data-parallel axis inside the
jitted step), with Flax's semantics over NCHW: one-pass fp32 statistics,
``var = max(E[x²] − E[x]², 0)``, the pair ``[mean, mean(x²)]`` averaged over
the process set in one collective, momentum 0.9 (the caller's; Flax's
default 0.99) with the biased variance fed to the running statistics, and
the output cast to the input's dtype. Parameters and statistics carry the
port's BatchNorm names (``weight``, ``bias``, ``running_mean``,
``running_var``), so ``models.resnet.load_flax_variables`` fills them from
a Flax tree unchanged.

The collective is an exact in-step all-reduce on the set's group, the
counterpart of ``lax.pmean``: it never rides the fusion runtime's queue or
its wire. :func:`allreduce_` fences the runtime first, so buckets already
queued go first on every rank, then all-reduces in place on the caller's
stream. Its backward all-reduces the cotangent the same way (the transpose
of ``psum`` under ``make_train_step``'s ``shard_map``), which makes the
input gradient that of the sum of every rank's loss. Training always takes
this path, at one rank too, as JAX does. ``launches`` counts the
collectives.
"""

import torch
import torch.distributed as dist
from torch import nn

from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops.wire import fp32_reciprocal

# Collectives issued (forward and backward), for the card's step counts.
launches = 0


def allreduce_(t, process_set=None):
    """Sum ``t`` over ``process_set`` in place, after the fusion runtime's
    buckets in flight, on the current stream."""
    global launches
    from horovod_tpu_torch.ops.collective_ops import fence, launch
    ps = global_process_set if process_set is None else process_set
    fence()
    launch(dist.all_reduce, t, group=ps.group)
    launches += 1
    return t


class _Pmean(torch.autograd.Function):
    """``lax.pmean`` of the stacked statistics: forward and backward both
    sum over the set and scale by 1/n (XLA's product with the fp32
    reciprocal)."""

    @staticmethod
    def forward(ctx, stats, process_set):
        ctx.process_set = process_set
        ps = global_process_set if process_set is None else process_set
        ctx.scale = fp32_reciprocal(ps.size())
        return allreduce_(stats.clone(), process_set).mul_(ctx.scale)

    @staticmethod
    def backward(ctx, grad):
        return allreduce_(grad.contiguous().clone(),
                          ctx.process_set).mul_(ctx.scale), None


class SyncBatchNorm(nn.Module):
    """Drop-in BatchNorm with statistics over every rank of
    ``process_set`` (None: the global set), over the channel axis (dim 1)
    of an (N, C, ...) input. ``zero_scale`` starts the scale at zero (Flax's
    ``scale_init=zeros``, the last BatchNorm of a ResNet block)."""

    def __init__(self, features, momentum=0.99, epsilon=1e-5,
                 use_bias=True, use_scale=True, zero_scale=False,
                 process_set=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.zero_scale = zero_scale
        self.process_set = process_set
        self.weight = nn.Parameter(torch.empty(features)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(0.0 if self.zero_scale else 1.0)
            if self.bias is not None:
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            stats = torch.stack([xf.mean(dim=dims),
                                 xf.square().mean(dim=dims)])
            mean, sq = _Pmean.apply(stats, self.process_set)
            var = torch.clamp_min(sq - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.reshape(shape)) * torch.rsqrt(
            var + self.epsilon).reshape(shape)
        if self.weight is not None:
            y = y * self.weight.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)

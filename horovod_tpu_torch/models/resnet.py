"""ResNet family in PyTorch.

Port of the JAX package's ``models/resnet.py`` (Flax), the reference's own
benchmark model (reference: docs/benchmarks.rst:15-64): the same blocks,
stems, widths and initializers, with ``dtype`` activations (bf16 by default)
over fp32 parameters and batch statistics and an fp32 classifier.

The public forward takes NHWC images like the Flax model. Inside, the
network runs on ``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC
tensor is already a channels_last NCHW view, so no copy is made and the
convolutions run channels-last.

Flax semantics kept on purpose:

- ``SAME`` padding is Flax's: a strided window pads (0, 1) where
  ``padding=1`` would pad (1, 1), so convolutions and the max-pool pad
  explicitly (``-inf`` for the pool).
- BatchNorm is Flax's: momentum 0.9 (torch's 0.1), epsilon 1e-5, statistics
  in fp32, and the running variance is fed the biased batch variance
  (``nn.BatchNorm2d`` feeds the unbiased one). The last BatchNorm of each
  block starts at zero scale. ``sync_batch_norm=<process set>`` swaps every
  BatchNorm for ``ops/sync_batch_norm.py::SyncBatchNorm`` over that set
  (JAX's ``sync_batch_norm_axis``), under the same names.
- Products at Flax's DEFAULT precision (``parallel/tp.py::at_precision``), as
  no layer of the Flax model sets one: on CUDA an fp32 convolution or
  classifier product runs in TF32, forward and backward (``Dense_0`` takes
  ``precision="highest"`` for full fp32). The bf16 convolutions do not
  read it.
- Submodules carry Flax's names (``conv_init``, ``bn_init``,
  ``BottleneckResNetBlock_<i>/Conv_0``, ``Dense_0``, ...), so
  :func:`load_flax_variables` maps a Flax variable tree onto the module by
  name.
"""

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.sync_batch_norm import SyncBatchNorm
from horovod_tpu_torch.parallel.tp import (Dense, FlaxKernel, at_precision,
                                           lecun_normal_)


def _same_pads(size, k, s):
    """Flax/XLA ``SAME`` padding (low, high) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x, k, s):
    """``flax.linen.max_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW:
    padded explicitly with -inf, since Flax's split may be asymmetric."""
    ph = _same_pads(x.shape[2], k, s)
    pw = _same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                              value=float("-inf")), k, s)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NCHW: fp32 weight (OIHW) cast to the
    activation dtype; ``padding`` is ``"SAME"`` or explicit
    ``((top, bottom), (left, right))``; the product at DEFAULT. With
    ``use_bias`` (ResNet's convolutions have none), an fp32 bias cast to
    the activation dtype is added to the product's rounded output, as Flax
    adds it."""

    def __init__(self, in_features, features, kernel_size, strides=(1, 1),
                 padding="SAME", use_bias=False):
        super().__init__()
        self.weight = FlaxKernel(torch.empty(features, in_features,
                                             *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.kernel_size[0] * \
            self.kernel_size[1]
        with torch.no_grad():
            lecun_normal_(self.weight, fan_in, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        if self.padding == "SAME":
            ph = _same_pads(x.shape[2], self.kernel_size[0], self.strides[0])
            pw = _same_pads(x.shape[3], self.kernel_size[1], self.strides[1])
        else:
            ph, pw = self.padding
        pad = (ph[0], pw[0])
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        y = at_precision(None, F.conv2d, x, self.weight.to(x.dtype), None,
                         self.strides, pad)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of NCHW, with fp32 scale, bias and running statistics."""

    def __init__(self, features, momentum=0.9, epsilon=1e-5,
                 zero_scale=False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            # invstd = (biased batch variance + eps) ** -0.5, in fp32.
            var = invstd.float().pow(-2).sub_(self.epsilon)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.float(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


def _add_norm(block, norm, features, zero_scale=False):
    """Register the block's next BatchNorm under Flax's name for it
    (``BatchNorm_<i>``, or ``SyncBatchNorm_<i>`` for the synchronized
    class) and return it."""
    prefix = getattr(norm, "func", norm).__name__
    m = norm(features, zero_scale=zero_scale)
    setattr(block, f"{prefix}_{len(block._norms)}", m)
    block._norms.append(m)
    return m


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features, filters, strides=(1, 1), act=F.relu,
                 norm=BatchNorm):
        super().__init__()
        self.act = act
        self._norms = []
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides)
        _add_norm(self, norm, filters)
        self.Conv_1 = Conv(filters, filters, (3, 3))
        _add_norm(self, norm, filters, zero_scale=True)
        self.has_proj = tuple(strides) != (1, 1) or in_features != filters
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x):
        n0, n1 = self._norms
        y = self.act(n0(self.Conv_0(x)))
        y = n1(self.Conv_1(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return self.act(residual + y)


class BottleneckResNetBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features, filters, strides=(1, 1), act=F.relu,
                 norm=BatchNorm):
        super().__init__()
        self.act = act
        self._norms = []
        self.Conv_0 = Conv(in_features, filters, (1, 1))
        _add_norm(self, norm, filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides)
        _add_norm(self, norm, filters)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1))
        _add_norm(self, norm, filters * 4, zero_scale=True)
        self.has_proj = tuple(strides) != (1, 1) or \
            in_features != filters * 4
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x):
        n0, n1, n2 = self._norms
        y = self.act(n0(self.Conv_0(x)))
        y = self.act(n1(self.Conv_1(y)))
        y = n2(self.Conv_2(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.has_proj else x
        return self.act(residual + y)


class ResNet(nn.Module):
    """``stem="conv"``: the classic 7x7 stride-2 stem. ``"space_to_depth"``:
    2x2 pixel blocks folded into channels, then a 4x4 stride-1 conv over the
    same 8x8 field (the JAX package's TPU stem, kept for parity).
    ``sync_batch_norm``: a process set whose ranks every BatchNorm's
    statistics are synchronized over, or None for plain BatchNorm."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, act=F.relu,
                 stem="conv", in_channels=3, generator=None,
                 sync_batch_norm=None):
        super().__init__()
        norm = BatchNorm if sync_batch_norm is None else partial(
            SyncBatchNorm, momentum=0.9, epsilon=1e-5,
            process_set=sync_batch_norm)
        self.dtype = dtype
        self.act = act
        self.stem = stem
        if stem == "space_to_depth":
            self.conv_init = Conv(4 * in_channels, num_filters, (4, 4))
        elif stem == "conv":
            self.conv_init = Conv(in_channels, num_filters, (7, 7), (2, 2),
                                  padding=((3, 3), (3, 3)))
        else:
            raise ValueError(f"unknown stem {stem!r} "
                             "(use 'conv' or 'space_to_depth')")
        self.bn_init = norm(num_filters)
        self.block_names = []
        features = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(features, filters, strides,
                                              act=act, norm=norm))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.Dense_0 = Dense(features, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Flax's initializers, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm, SyncBatchNorm)):
                m.reset_parameters(generator)
        self.Dense_0.reset_parameters(generator)

    def forward(self, x):
        """``x``: (B, H, W, C) images; returns fp32 logits (B, classes)."""
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            B, H, W, C = x.shape
            if H % 2 or W % 2:
                raise ValueError(f"space_to_depth stem needs even spatial "
                                 f"dims, got {(H, W)}")
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        x = x.permute(0, 3, 1, 2)
        x = max_pool_same(self.act(self.bn_init(self.conv_init(x))), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        # The classifier runs in fp32 (Dense_0's dtype), not dtype.
        return self.Dense_0(x)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckResNetBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckResNetBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckResNetBlock)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def load_flax_variables(module, variables):
    """Fill ``module`` from the JAX package's ResNet variables.

    ``variables`` is ``{"params": ..., "batch_stats": ...}`` as nested dicts
    of numpy arrays under Flax's names. Conv kernels go HWIO -> OIHW, the
    Dense kernel (in, out) -> (out, in), BatchNorm ``scale`` -> ``weight``,
    ``mean``/``var`` -> the running statistics. Every parameter and buffer
    of ``module`` must be filled, with matching shapes.
    """
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    filled = set()
    for collection, names in (("params", _PARAM_NAMES),
                              ("batch_stats", _STAT_NAMES)):
        for path, value in _leaves(variables.get(collection, {})):
            if path[-1] not in names:
                raise KeyError(f"unexpected Flax leaf {'/'.join(path)}")
            key = ".".join(path[:-1] + (names[path[-1]],))
            if key not in targets:
                raise KeyError(f"Flax leaf {'/'.join(path)} has no "
                               f"counterpart {key} in the module")
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if path[-1] == "kernel":
                arr = FlaxKernel.from_flax(arr)
            t = targets[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: Flax shape {tuple(arr.shape)} vs "
                                 f"module shape {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(arr)
            filled.add(key)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"no Flax variable for {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    return module

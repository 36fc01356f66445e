"""Inception V3 in PyTorch.

Port of the JAX package's ``models/inception.py`` (Flax), Szegedy et al.
2015: factorized 1 x 7 / 7 x 1 convolutions, grid reductions by parallel
stride-2 branches, an optional auxiliary classifier over the 17 x 17 grid.
One of the reference's headline benchmark models (reference:
docs/benchmarks.rst:12-13). ``dtype`` activations (bf16 by default) over
fp32 parameters and batch statistics; the classifiers in fp32.

Flax semantics kept on purpose:

- ``ConvBN`` is a bias-free convolution, BatchNorm (momentum 0.9, epsilon
  1e-3; ``models/resnet.py``'s ``BatchNorm``, Flax's statistics) and ReLU.
- ``SAME`` is Flax's padding on each axis on its own (a 1 x 7 kernel pads
  the width only); ``VALID`` pads nothing. The 3 x 3 stride-1 average pool
  of the A, C and E blocks is ``SAME`` and counts the padding in its mean
  (``flax.linen.avg_pool``'s ``count_include_pad=True``); the max-pools and
  the aux head's 5 x 5 stride-3 average pool are ``VALID``.
- Submodules carry Flax's auto-names, numbered in the order Flax
  constructs them (an outer ``ConvBN`` of a chain before the inner ones:
  ``c(64, (5, 5))(c(48)(x))`` is ``ConvBN_1`` over ``ConvBN_2``), so
  :func:`load_flax_inception` (``models/resnet.py::load_flax_variables``)
  maps a Flax variable tree by name.
- ``train`` is the module's mode: in ``model.train()`` BatchNorm uses and
  updates the batch statistics, dropout is on and, with ``aux_logits``,
  the forward returns ``(logits, aux_logits)``.

The forward takes NHWC images, as the Flax model does, and runs on their
channels-last NCHW view; branches concatenate on the channel axis.
"""

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import (BatchNorm, Conv,
                                             load_flax_variables)
from horovod_tpu_torch.parallel.tp import Dense

VALID = ((0, 0), (0, 0))


class ConvBN(nn.Module):
    """conv -> BatchNorm -> ReLU, the Inception cell."""

    def __init__(self, in_features, filters, kernel=(1, 1), strides=(1, 1),
                 padding="SAME"):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, kernel, strides,
                           padding=VALID if padding == "VALID" else padding)
        self.BatchNorm_0 = BatchNorm(filters, momentum=0.9, epsilon=1e-3)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _cells(block, specs):
    """Register ``ConvBN_<i>`` for each (in, out, kernel, strides, padding)
    spec, in Flax's construction order; return them."""
    cells = []
    for i, spec in enumerate(specs):
        cell = ConvBN(*spec)
        setattr(block, f"ConvBN_{i}", cell)
        cells.append(cell)
    return cells


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, in_features, pool_features):
        super().__init__()
        n = in_features
        self.c = _cells(self, [(n, 64), (48, 64, (5, 5)), (n, 48),
                               (96, 96, (3, 3)), (64, 96, (3, 3)), (n, 64),
                               (n, pool_features)])
        self.out_features = 224 + pool_features

    def forward(self, x):
        c = self.c
        b1 = c[0](x)
        b5 = c[1](c[2](x))
        b3 = c[3](c[4](c[5](x)))
        bp = c[6](_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    """Grid reduction 35 x 35 -> 17 x 17."""

    def __init__(self, in_features):
        super().__init__()
        n = in_features
        self.c = _cells(self, [(n, 384, (3, 3), (2, 2), "VALID"),
                               (96, 96, (3, 3), (2, 2), "VALID"),
                               (64, 96, (3, 3)), (n, 64)])
        self.out_features = 480 + n

    def forward(self, x):
        c = self.c
        return torch.cat([c[0](x), c[1](c[2](c[3](x))), _max_pool_valid(x)],
                         dim=1)


class InceptionC(nn.Module):
    """Factorized 7 x 7 block at 17 x 17."""

    def __init__(self, in_features, channels_7x7):
        super().__init__()
        n, c7 = in_features, channels_7x7
        self.c = _cells(self, [(n, 192), (c7, 192, (7, 1)),
                               (c7, c7, (1, 7)), (n, c7),
                               (c7, 192, (1, 7)), (c7, c7, (7, 1)),
                               (c7, c7, (1, 7)), (c7, c7, (7, 1)), (n, c7),
                               (n, 192)])
        self.out_features = 768

    def forward(self, x):
        c = self.c
        b1 = c[0](x)
        b7 = c[1](c[2](c[3](x)))
        bd = c[4](c[5](c[6](c[7](c[8](x)))))
        bp = c[9](_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    """Grid reduction 17 x 17 -> 8 x 8."""

    def __init__(self, in_features):
        super().__init__()
        n = in_features
        self.c = _cells(self, [(192, 320, (3, 3), (2, 2), "VALID"),
                               (n, 192),
                               (192, 192, (3, 3), (2, 2), "VALID"),
                               (192, 192, (7, 1)), (192, 192, (1, 7)),
                               (n, 192)])
        self.out_features = 512 + n

    def forward(self, x):
        c = self.c
        b3 = c[0](c[1](x))
        b7 = c[2](c[3](c[4](c[5](x))))
        return torch.cat([b3, b7, _max_pool_valid(x)], dim=1)


class InceptionE(nn.Module):
    """Expanded filter bank at 8 x 8."""

    def __init__(self, in_features):
        super().__init__()
        n = in_features
        self.c = _cells(self, [(n, 320), (n, 384), (384, 384, (1, 3)),
                               (384, 384, (3, 1)), (448, 384, (3, 3)),
                               (n, 448), (384, 384, (1, 3)),
                               (384, 384, (3, 1)), (n, 192)])
        self.out_features = 2048

    def forward(self, x):
        c = self.c
        b1 = c[0](x)
        y = c[1](x)
        b3 = torch.cat([c[2](y), c[3](y)], dim=1)
        z = c[4](c[5](x))
        bd = torch.cat([c[6](z), c[7](z)], dim=1)
        bp = c[8](_avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    """Auxiliary classifier over the 17 x 17 grid (a training regularizer);
    its ``Dense_0`` in fp32."""

    def __init__(self, in_features, num_classes):
        super().__init__()
        self.c = _cells(self, [(in_features, 128),
                               (128, 768, (5, 5), (1, 1), "VALID")])
        self.Dense_0 = Dense(768, num_classes, dtype=torch.float32)

    def forward(self, x):
        x = F.avg_pool2d(x, 5, 3)
        x = self.c[1](self.c[0](x))
        return self.Dense_0(x.mean(dim=(2, 3)))


class InceptionV3(nn.Module):
    """The stem (``ConvBN_0``-``4``), 3 x A, B, 4 x C, (the aux head), D,
    2 x E, global average, dropout and the fp32 ``Dense_0``. Parameters are
    drawn from ``generator`` with Flax's initializers."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 aux_logits=False, dropout_rate=0.5, generator=None):
        super().__init__()
        self.dtype = dtype
        self.aux_logits = aux_logits
        self.dropout_rate = dropout_rate
        self.stem = _cells(self, [(3, 32, (3, 3), (2, 2), "VALID"),
                                  (32, 32, (3, 3), (1, 1), "VALID"),
                                  (32, 64, (3, 3)), (64, 80),
                                  (80, 192, (3, 3), (1, 1), "VALID")])
        n = 192
        self.blocks = []
        for i, pf in enumerate((32, 64, 64)):
            n = self._block(f"InceptionA_{i}", InceptionA(n, pf))
        n = self._block("InceptionB_0", InceptionB(n))
        for i, c7 in enumerate((128, 160, 160, 192)):
            n = self._block(f"InceptionC_{i}", InceptionC(n, c7))
        self.aux_at = len(self.blocks)
        if aux_logits:
            self.InceptionAux_0 = InceptionAux(n, num_classes)
        n = self._block("InceptionD_0", InceptionD(n))
        for i in range(2):
            n = self._block(f"InceptionE_{i}", InceptionE(n))
        self.Dense_0 = Dense(n, num_classes, dtype=torch.float32)
        self.reset_parameters(generator)

    def _block(self, name, block):
        setattr(self, name, block)
        self.blocks.append(block)
        return block.out_features

    def reset_parameters(self, generator=None):
        """Flax's initializers, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm, Dense)):
                m.reset_parameters(generator)

    def forward(self, x):
        """``x``: (B, H, W, C) images; fp32 logits (B, classes), and in
        training with ``aux_logits`` the pair (logits, aux logits)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        s = self.stem
        x = s[2](s[1](s[0](x)))
        x = _max_pool_valid(x)
        x = _max_pool_valid(s[4](s[3](x)))
        aux = None
        for i, block in enumerate(self.blocks):
            if i == self.aux_at and self.aux_logits and self.training:
                aux = self.InceptionAux_0(x)
            x = block(x)
        x = F.dropout(x.mean(dim=(2, 3)), self.dropout_rate, self.training)
        x = self.Dense_0(x)
        return (x, aux) if aux is not None else x


load_flax_inception = load_flax_variables

__all__ = ["ConvBN", "InceptionA", "InceptionB", "InceptionC", "InceptionD",
           "InceptionE", "InceptionAux", "InceptionV3",
           "load_flax_inception"]

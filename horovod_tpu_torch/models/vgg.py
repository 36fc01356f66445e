"""The VGG family in PyTorch.

Port of the JAX package's ``models/vgg.py`` (Flax). VGG-16 is one of the
reference's headline benchmark models (reference: docs/benchmarks.rst:12-13).
Stages of 3 x 3 ``SAME`` convolutions with biases and ReLU, each followed by
a 2 x 2 stride-2 ``VALID`` max-pool; ``classic_head=True`` keeps the
published head (flatten, two 4096-wide Dense layers with dropout: 138M
parameters at 1000 classes), ``classic_head=False`` a global-average head.
``dtype`` activations (bf16 by default) over fp32 parameters; the
classifier ``head`` in fp32.

The forward takes NHWC images like the Flax model and runs its trunk on the
channels-last NCHW view (``models/resnet.py``'s ``Conv``). Flax flattens the
last grid in (h, w, c) order, so the classic head flattens the NHWC view of
that grid, a view of channels-last memory: ``fc0``'s rows are Flax's, and
:func:`load_flax_vgg` loads them as they are. The classic head's input width
depends on the (square) image's side, so the model takes ``image_size``
(224 by default). Dropout follows the module's mode (``model.train()``/``eval()``),
as BatchNorm does in the port's vision models, and draws from torch's
stream.
"""

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.models.resnet import Conv
from horovod_tpu_torch.parallel.tp import Dense

# (num_convs, filters) per stage; a max-pool after each stage.
_CFGS = {
    11: ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512)),
    13: ((2, 64), (2, 128), (2, 256), (2, 512), (2, 512)),
    16: ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    19: ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


class VGG(nn.Module):
    """Convolutions ``conv<i>_<j>`` (stage i, layer j), then ``fc0``/``fc1``
    (classic head) and the fp32 ``head``. Parameters are drawn from
    ``generator`` with Flax's initializers."""

    def __init__(self, stage_cfg=_CFGS[16], num_classes=1000,
                 dtype=torch.bfloat16, classic_head=True, dropout_rate=0.5,
                 image_size=224, generator=None):
        super().__init__()
        self.dtype = dtype
        self.classic_head = classic_head
        self.dropout_rate = dropout_rate
        self.stages = []
        features = 3
        for i, (reps, filters) in enumerate(stage_cfg):
            names = []
            for j in range(reps):
                setattr(self, f"conv{i}_{j}",
                        Conv(features, filters, (3, 3), use_bias=True))
                names.append(f"conv{i}_{j}")
                features = filters
            self.stages.append(names)
        if classic_head:
            side = image_size // 2 ** len(stage_cfg)    # after the pools
            if side < 1:
                raise ValueError(f"image side {image_size} leaves no grid "
                                 f"for the classic head")
            self.fc0 = Dense(side * side * features, 4096, dtype=dtype)
            self.fc1 = Dense(4096, 4096, dtype=dtype)
            features = 4096
        self.head = Dense(features, num_classes, dtype=torch.float32)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Flax's initializers, drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                m.reset_parameters(generator)

    def forward(self, x):
        """``x``: (B, H, W, C) images; returns fp32 logits (B, classes)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for names in self.stages:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = F.max_pool2d(x, 2, 2)
        if self.classic_head:
            x = x.permute(0, 2, 3, 1).flatten(1)      # Flax's (h, w, c)
            for fc in (self.fc0, self.fc1):
                x = F.dropout(F.relu(fc(x)), self.dropout_rate,
                              self.training)
        else:
            x = x.mean(dim=(2, 3))
        return self.head(x)


VGG11 = partial(VGG, stage_cfg=_CFGS[11])
VGG13 = partial(VGG, stage_cfg=_CFGS[13])
VGG16 = partial(VGG, stage_cfg=_CFGS[16])
VGG19 = partial(VGG, stage_cfg=_CFGS[19])

load_flax_vgg = load_flax

__all__ = ["VGG", "VGG11", "VGG13", "VGG16", "VGG19", "load_flax_vgg"]

"""Small MLP (MNIST-scale), the smoke-test model, in PyTorch.

Port of the JAX package's ``models/mlp.py`` (Flax): flatten, ReLU Dense
layers named ``Dense_0`` ... as Flax names them, and an fp32 last layer.
Flax infers a layer's input width; here the first one is ``in_features``
(28 x 28 by default). ``load_flax_mlp``
(:func:`horovod_tpu_torch.models.gpt.load_flax`) fills it from the Flax
variable tree.
"""

import torch
from torch import nn

from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.parallel.tp import Dense, reset_flax_


class MLP(nn.Module):
    def __init__(self, features=(128, 64, 10), dtype=torch.float32,
                 in_features=28 * 28, generator=None):
        super().__init__()
        self.dtype = dtype
        self.features = tuple(features)
        widths = (in_features,) + self.features
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            last = i == len(self.features) - 1
            setattr(self, f"Dense_{i}", Dense(
                a, b, dtype=torch.float32 if last else dtype))
        reset_flax_(self, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        n = len(self.features)
        for i in range(n - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{n - 1}")(x)


load_flax_mlp = load_flax

__all__ = ["MLP", "load_flax_mlp"]

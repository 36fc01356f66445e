"""Vision Transformer (ViT) in PyTorch.

Port of the JAX package's ``models/vit.py`` (Flax): one strided patch
convolution (with a bias) over NHWC images, learned position embeddings,
pre-LN encoder blocks from ``parallel/tp.py`` (``TPTransformerBlock`` with
``causal=False``), a final LayerNorm, a mean pool over the patches in fp32
and an fp32 ``head``; ``dtype`` activations over fp32 parameters. No cls
token: ViT-B/16 at 224 x 224 attends over 14 x 14 = 196 patches, a ragged
length for the flash kernels' 64-key tiles (the last tile holds 4 keys),
which they mask as it is.

Submodules carry Flax's names (``patch_embed``, ``pos_emb``, ``layer_<i>``,
``ln_f``, ``head``), so ``load_flax_vit`` (:func:`load_flax`) fills a
module from the Flax variable tree. ``remat`` runs each block under
``torch.utils.checkpoint``; ``tp_axis`` shards the blocks' heads and MLP
columns over that in-step axis (``parallel/tp.py``).
"""

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.models.resnet import Conv
from horovod_tpu_torch.parallel.tp import (Dense, LayerNorm,
                                           TPTransformerBlock, remat,
                                           reset_flax_)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    dtype: Any = torch.float32
    tp_axis: Optional[str] = None   # tensor parallelism over heads/MLP
    use_flash: bool = False         # the CUDA flash kernels (ops/kernels)
    remat: bool = False

    @staticmethod
    def base(**kw):
        """ViT-B/16 (86M parameters)."""
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(image_size=32, patch_size=8, hidden_size=64,
                    num_layers=2, num_heads=4, intermediate_size=128,
                    num_classes=10)
        base.update(kw)
        return ViTConfig(**base)


class ViT(nn.Module):
    """Patch embed -> ``num_layers`` encoder blocks named ``layer_<i>`` ->
    ``ln_f`` -> fp32 mean pool -> fp32 ``head``. Parameters are drawn from
    ``generator`` with Flax's initializers."""

    def __init__(self, config, in_channels=3, generator=None):
        super().__init__()
        c = config
        self.config = c
        p = c.patch_size
        self.patch_embed = Conv(in_channels, c.hidden_size, (p, p), (p, p),
                                padding=((0, 0), (0, 0)), use_bias=True)
        self.n_patches = (c.image_size // p) ** 2
        self.pos_emb = nn.Parameter(torch.empty(self.n_patches,
                                                c.hidden_size))
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", TPTransformerBlock(
                c.num_heads, c.hidden_size, c.intermediate_size,
                dtype=c.dtype, causal=False, use_flash=c.use_flash,
                axis_name=c.tp_axis))
        self.ln_f = LayerNorm(c.hidden_size, c.dtype)
        self.head = Dense(c.hidden_size, c.num_classes, dtype=torch.float32)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_flax_(self, generator)
        self.patch_embed.reset_parameters(generator)
        with torch.no_grad():
            self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def forward(self, images):
        """``images`` (B, H, W, C), NHWC as Flax takes them -> fp32 logits
        (B, num_classes)."""
        c = self.config
        # NHWC viewed as NCHW is channels-last: no copy for the convolution.
        x = self.patch_embed(images.to(c.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)              # (B, n_patches, H)
        if x.shape[1] != self.n_patches:
            # A smaller image would silently take the first rows of the 2-D
            # position grid (wrong geometry): fail loudly, as JAX does.
            raise ValueError(
                f"got {x.shape[1]} patches but config.image_size="
                f"{c.image_size} implies {self.n_patches}; resize the input "
                "or the config")
        x = x + self.pos_emb.to(c.dtype)[None]
        for i in range(c.num_layers):
            block = getattr(self, f"layer_{i}")
            x = remat(block, (x,)) if c.remat else block(x)
        x = self.ln_f(x).float().mean(dim=1)         # mean pool, fp32
        return self.head(x)


load_flax_vit = load_flax

__all__ = ["ViTConfig", "ViT", "load_flax_vit"]

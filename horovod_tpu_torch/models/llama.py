"""LLaMA-family decoder-only LM in PyTorch: RMSNorm, RoPE, SwiGLU,
grouped-query attention.

Port of the JAX package's ``models/llama.py`` (Flax): token embedding only
(positions enter through RoPE inside every attention block), pre-RMSNorm
blocks with grouped-query attention (``num_kv_heads < num_heads``; the
flash kernels read the narrow K/V) and a bias-free SwiGLU MLP, a final
RMSNorm and an fp32 ``lm_head`` with no bias; ``dtype`` activations over
fp32 parameters. Submodules carry Flax's names, so ``load_flax_llama``
(:func:`horovod_tpu_torch.models.gpt.load_flax`) fills a module from the
Flax variable tree.

Ported: the dense model, tensor parallelism (``tp_axis``), sequence
parallelism (``sp_axis``/``sp_impl``; each attention block rotates Q and K at
the shard's global positions, as JAX's ``TPSelfAttention`` does),
``features_only``, ``remat`` and the decode route (``model(ids, pos=t,
cache=cache)``, as GPT's: the cache keeps the kv heads narrow, holds K
rotated at its positions, and is int8 with ``kv_cache_int8``).
"""

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.parallel.tp import (Dense, RMSNorm, TPSelfAttention,
                                           TPSwiGLUMlp, remat, reset_flax_)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None    # None -> MHA
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.float32
    tp_axis: Optional[str] = None   # "tp": heads and MLP sharded over it
    use_flash: bool = False         # the CUDA flash kernels (ops/kernels)
    sp_axis: Optional[str] = None   # sequence parallelism: tokens sharded
    sp_impl: str = "ring"           # "ring" | "ulysses" (parallel/sequence)
    remat: bool = False
    kv_cache_int8: bool = False

    @staticmethod
    def tiny(**kw):
        """For tests / dry runs (GQA on: 4 query heads per 2 kv heads)."""
        base = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
                    num_kv_heads=2, intermediate_size=128,
                    max_position_embeddings=64)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw):
        """LLaMA-2-7B shapes (MHA, 4k context)."""
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_8b(**kw):
        """LLaMA-3-8B shapes: GQA 32q/8kv, 128k vocab, theta 5e5."""
        base = dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                    num_heads=32, num_kv_heads=8, intermediate_size=14336,
                    max_position_embeddings=8192, rope_theta=500000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def bench(**kw):
        """``bench.py``'s ~400M config: 24 layers, hidden 1024, 16 query
        heads over 8 kv heads, SwiGLU 2816."""
        base = dict(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, num_kv_heads=8, intermediate_size=2816,
                    max_position_embeddings=4096)
        base.update(kw)
        return LlamaConfig(**base)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm block: x + attention(ln_attn(x)) with GQA, RoPE and no
    biases, then + SwiGLU mlp(ln_mlp(x))."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.ln_attn = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.attention = TPSelfAttention(
            c.num_heads, c.hidden_size, dtype=c.dtype, causal=True,
            use_flash=c.use_flash, num_kv_heads=c.num_kv_heads,
            rope_theta=c.rope_theta, use_bias=False, axis_name=c.tp_axis,
            sp_axis=c.sp_axis, sp_impl=c.sp_impl,
            cache_len=c.max_position_embeddings,
            kv_cache_int8=c.kv_cache_int8)
        self.ln_mlp = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.mlp = TPSwiGLUMlp(c.intermediate_size, c.hidden_size,
                               dtype=c.dtype, axis_name=c.tp_axis)

    def forward(self, x, pos=None, cache=None):
        x = x + self.attention(self.ln_attn(x), pos=pos,
                               cache=None if cache is None
                               else cache.sub("attention"))
        return x + self.mlp(self.ln_mlp(x))


class LlamaEmbed(nn.Module):
    """Token embedding only, cast to ``dtype``; no position table."""

    def __init__(self, config):
        super().__init__()
        self.dtype = config.dtype
        self.tok_emb = nn.Embedding(config.vocab_size, config.hidden_size)

    def forward(self, input_ids, pos=None):
        """``pos`` is taken for the decoder interface; it embeds nothing."""
        return self.tok_emb(input_ids).to(self.dtype)


class LlamaHead(nn.Module):
    """Final RMSNorm, then the bias-free fp32 lm_head (fp32 logits)."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.ln_f = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.lm_head = Dense(c.hidden_size, c.vocab_size, use_bias=False,
                             dtype=torch.float32)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class Llama(nn.Module):
    """Embed -> ``num_layers`` blocks named ``layer_<i>`` -> head.
    Parameters are drawn from ``generator`` with Flax's initializers.
    ``decode=True``: a model that runs the decode route alone."""

    def __init__(self, config, decode=False, generator=None):
        super().__init__()
        c = config
        self.decode = decode
        self.config = c
        self.embed = LlamaEmbed(c)
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", LlamaBlock(c))
        self.head = LlamaHead(c)
        reset_flax_(self, generator)

    def forward(self, input_ids, pos=None, features_only=False, cache=None):
        """``input_ids`` (B, L) -> fp32 logits (B, L, vocab), or the pre-head
        hidden states (B, L, H) with ``features_only``. With ``cache``, the
        decode route at position ``pos`` (an int, or (B,) per-row)."""
        decode = cache is not None
        if self.decode and not decode:
            raise ValueError("decode mode reads a decode cache: pass cache= "
                             "(generate.init_decode_cache)")
        if decode and pos is None:
            raise ValueError("decode mode requires pos (the token's "
                             "global position)")
        if decode:
            cache = cache.for_feed()
        x = self.embed(input_ids, pos)
        for i in range(self.config.num_layers):
            block = getattr(self, f"layer_{i}")
            if decode:
                x = block(x, pos=pos, cache=cache.sub(f"layer_{i}"))
            elif self.config.remat:
                x = remat(block, (x,))
            else:
                x = block(x)
        if features_only:
            return x
        return self.head(x)


load_flax_llama = load_flax

__all__ = ["LlamaConfig", "LlamaBlock", "LlamaEmbed", "LlamaHead", "Llama",
           "load_flax_llama"]

"""BERT in PyTorch: the encoder, MLM and NSP heads.

Port of the JAX package's ``models/bert.py`` (Flax): token, position and
token-type embeddings (three ``Embed`` tables), ``ln_emb``, post-LN blocks
(``ln_attn(x + drop(attention(x)))``, then ``ln_mlp(x + drop(mlp(x)))``)
with their own fused ``qkv`` and ``out`` Dense layers, a tanh pooler over
the first token, and in :class:`BertForPreTraining` the fp32 MLM and NSP
heads; ``dtype`` activations over fp32 parameters. Submodules carry Flax's
names, so ``load_flax_bert`` (:func:`horovod_tpu_torch.models.gpt.load_flax`)
fills a module from the Flax variable tree.

Attention takes the flash kernels, non-causal, exactly where JAX's does:
``use_flash`` set, no padding mask and no attention dropout
(``deterministic``, or a rate of 0). Otherwise it takes bert.py's own plain
path: the scores' product in ``dtype``, divided by sqrt(head_dim) in fp32
(as ``jnp`` promotes a ``dtype`` array by a numpy float), padded keys set to
-1e9, an fp32 softmax cast to ``dtype``, dropout on the probabilities, then
P V; both products at DEFAULT precision.

Dropout follows Flax's ``deterministic`` argument (default True), not
``module.train()``; with it off, masks are drawn from the ``generator``
given to ``forward`` (the device's default one if None). ``remat`` runs each
block under ``torch.utils.checkpoint`` and replays its dropout masks.
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.ops.kernels.flash_attention import flash_attention
from horovod_tpu_torch.parallel.tp import (Dense, LayerNorm, at_precision,
                                           remat, reset_flax_)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # BERT-Large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: Any = torch.bfloat16
    use_flash: bool = False          # the CUDA flash kernels (ops/kernels)
    remat: bool = False

    @staticmethod
    def base(**kw):
        cfg = dict(hidden_size=768, num_layers=12, num_heads=12,
                   intermediate_size=3072)
        cfg.update(kw)
        return BertConfig(**cfg)

    @staticmethod
    def large(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        """For tests / dry runs."""
        cfg = dict(vocab_size=1024, hidden_size=128, num_layers=2,
                   num_heads=4, intermediate_size=256,
                   max_position_embeddings=128)
        cfg.update(kw)
        return BertConfig(**cfg)


def dropout(x, rate, deterministic, generator=None):
    """``flax.linen.Dropout``: ``x`` as it is when ``deterministic`` or the
    rate is 0; else each element kept with probability 1 - rate and scaled
    by 1 / (1 - rate), masks drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _plain_attention(q, k, v, mask, dtype, rate, deterministic, generator):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() \
        / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    probs = dropout(probs, rate, deterministic, generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class SelfAttention(nn.Module):
    """Fused ``qkv`` Dense, flash or plain attention, ``out`` Dense."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.config = c
        self.qkv = Dense(c.hidden_size, 3 * c.hidden_size, dtype=c.dtype)
        self.out = Dense(c.hidden_size, c.hidden_size, dtype=c.dtype)

    def forward(self, x, mask, deterministic=True, generator=None):
        c = self.config
        q, k, v = (t.unflatten(-1, (c.num_heads, -1))
                   for t in self.qkv(x).chunk(3, dim=-1))
        if c.use_flash and mask is None and (deterministic
                                             or c.dropout_rate == 0.0):
            out = flash_attention(q, k, v, causal=False)
        else:
            out = at_precision(None, _plain_attention, q, k, v, mask, c.dtype,
                               c.dropout_rate, deterministic, generator)
        return self.out(out.flatten(-2))


class TransformerBlock(nn.Module):
    """Post-LN block."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.rate = c.dropout_rate
        self.attention = SelfAttention(c)
        self.ln_attn = LayerNorm(c.hidden_size, c.dtype)
        self.mlp_in = Dense(c.hidden_size, c.intermediate_size, dtype=c.dtype)
        self.mlp_out = Dense(c.intermediate_size, c.hidden_size,
                             dtype=c.dtype)
        self.ln_mlp = LayerNorm(c.hidden_size, c.dtype)

    def forward(self, x, mask, deterministic=True, generator=None):
        a = self.attention(x, mask, deterministic, generator)
        a = dropout(a, self.rate, deterministic, generator)
        x = self.ln_attn(x + a)
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        h = dropout(h, self.rate, deterministic, generator)
        return self.ln_mlp(x + h)


class BertModel(nn.Module):
    """Embeddings -> ``ln_emb`` -> dropout -> ``num_layers`` blocks named
    ``layer_<i>``; returns the hidden states and the pooled first token."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.config = c
        self.tok_emb = nn.Embedding(c.vocab_size, c.hidden_size)
        self.pos_emb = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.type_emb = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.ln_emb = LayerNorm(c.hidden_size, c.dtype)
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", TransformerBlock(c))
        self.pooler = Dense(c.hidden_size, c.hidden_size, dtype=c.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic=True, generator=None):
        """``token_type_ids`` None means zeros; ``attention_mask`` (B, L),
        nonzero on the tokens to attend, None means no padding."""
        c = self.config
        L = input_ids.shape[1]
        if L > c.max_position_embeddings:
            raise ValueError(f"sequence {L} exceeds max_position_embeddings="
                             f"{c.max_position_embeddings}")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        dt = c.dtype
        x = self.tok_emb(input_ids).to(dt) \
            + self.pos_emb.weight[:L].to(dt)[None] \
            + self.type_emb(token_type_ids).to(dt)
        x = dropout(self.ln_emb(x), c.dropout_rate, deterministic, generator)
        mask = None if attention_mask is None else attention_mask.bool()
        for i in range(c.num_layers):
            block, args = getattr(self, f"layer_{i}"), (x, mask, deterministic,
                                                        generator)
            x = remat(block, args, generator) if c.remat else block(*args)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPreTraining(nn.Module):
    """``bert`` -> MLM (``mlm_transform``, gelu, ``mlm_ln``, fp32
    ``mlm_head``) and NSP (fp32 ``nsp_head`` over the pooled token) logits,
    both fp32. Parameters are drawn from ``generator`` with Flax's
    initializers."""

    def __init__(self, config, generator=None):
        super().__init__()
        c = config
        self.config = c
        self.bert = BertModel(c)
        self.mlm_transform = Dense(c.hidden_size, c.hidden_size, dtype=c.dtype)
        self.mlm_ln = LayerNorm(c.hidden_size, c.dtype)
        self.mlm_head = Dense(c.hidden_size, c.vocab_size,
                              dtype=torch.float32)
        self.nsp_head = Dense(c.hidden_size, 2, dtype=torch.float32)
        reset_flax_(self, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic=True, generator=None):
        """(mlm_logits (B, L, vocab), nsp_logits (B, 2)), fp32; ``generator``
        draws the dropout masks when ``deterministic`` is False."""
        x, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              deterministic, generator)
        mlm = self.mlm_ln(F.gelu(self.mlm_transform(x), approximate="tanh"))
        return self.mlm_head(mlm), self.nsp_head(pooled)


load_flax_bert = load_flax

__all__ = ["BertConfig", "SelfAttention", "TransformerBlock", "BertModel",
           "BertForPreTraining", "dropout", "load_flax_bert"]

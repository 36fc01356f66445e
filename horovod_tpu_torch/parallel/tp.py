"""Transformer layers of the JAX package's ``parallel/tp.py``, at tp = 1.

Port of the dense path GPT takes through ``ColumnParallelDense``,
``RowParallelDense``, ``plain_attention``, ``TPSelfAttention`` (full
sequence), ``TPMlp`` and ``TPTransformerBlock``. The port has no tensor-
parallel mesh yet (ROADMAP A12), so the layers are what the JAX modules are
outside ``shard_map``: the column- and row-parallel layers are dense layers,
and the row-parallel psum is the identity.

Flax semantics kept on purpose:

- Submodules carry Flax's names (``qkv``/``out``/``in`` with a ``shard``
  Dense, the row-parallel ``bias`` added after the product, ``ln_attn``,
  ``ln_mlp``, ``attention``, ``mlp``), so ``models/gpt.py::load_flax_gpt``
  maps a Flax tree onto a module by name.
- ``Dense(dtype=...)``: fp32 parameters, input, kernel and bias cast to
  ``dtype`` for the product.
- ``LayerNorm``: epsilon 1e-6, statistics in fp32, output cast to ``dtype``.
- ``gelu`` is the tanh approximation (``flax.linen.gelu``'s default).

Decode, sequence parallelism (``sp_axis``) and RoPE raise
``NotImplementedError`` naming the ROADMAP item that will bring them.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.kernels.flash_attention import flash_attention


def lecun_normal_(w, fan_in, generator=None):
    """``flax.linen.initializers.lecun_normal``: a normal truncated at two
    standard deviations, rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Dense(nn.Linear):
    """``flax.linen.Dense``: fp32 weight (out, in) and bias, the product in
    ``dtype``."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=dtype)`` over the last axis: fp32
    statistics, epsilon 1e-6, fp32 scale and bias, output in ``dtype``."""

    def __init__(self, features, dtype=torch.float32, epsilon=1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                         self.epsilon)
        return y.to(self.dtype)


class ColumnParallelDense(nn.Module):
    """Linear layer split on its output dim; at tp = 1 a Dense named
    ``shard``."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.shard = Dense(in_features, features, use_bias, dtype)

    def forward(self, x):
        return self.shard(x)


class RowParallelDense(nn.Module):
    """Linear layer split on its input dim; the partial products' psum is
    the identity at tp = 1, and the bias is added after it."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.shard = Dense(in_features, features, False, dtype)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = self.shard(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def plain_attention(q, k, v, out_dtype, mask=None, bias=None, causal=False):
    """Scaled scores, optional additive ``bias`` (h, Lq, Lk), -1e9 causal
    (end-aligned) and key masking (``mask`` (B, Lk), True on valid keys),
    fp32 softmax. q/k/v: (B, L, h, d)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias[None].to(scores.dtype)
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~keep, -1e9)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _not_yet(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class TPSelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection
    (column-parallel) and a row-parallel output projection.
    ``num_kv_heads`` < ``num_heads`` is grouped-query attention: the flash
    kernel reads the narrow K/V, the plain path broadcasts them."""

    def __init__(self, num_heads, hidden_size, dtype=torch.float32,
                 causal=False, use_flash=False, sp_axis=None, decode=False,
                 num_kv_heads=None, rope_theta=None, use_bias=True):
        super().__init__()
        if decode:
            _not_yet("decode with a KV cache", "A15")
        if sp_axis is not None:
            _not_yet("sequence parallelism (sp_axis)", "A12")
        if rope_theta is not None:
            _not_yet("rotary position embedding", "A6, LLaMA")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_kv_heads {kv_heads} must divide num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.num_kv_heads = kv_heads
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.causal = causal
        self.use_flash = use_flash
        self.qkv = ColumnParallelDense(
            hidden_size, (num_heads + 2 * kv_heads) * self.head_dim,
            use_bias=use_bias, dtype=dtype)
        self.out = RowParallelDense(num_heads * self.head_dim, hidden_size,
                                    use_bias=use_bias, dtype=dtype)

    def _attend(self, q, k, v, mask, bias=None):
        """Flash when ``use_flash`` and no mask, else plain attention."""
        flash = self.use_flash and mask is None
        if bias is not None and flash:
            raise ValueError("additive attention bias is supported on the "
                             "plain path only (not flash)")
        if flash:
            return flash_attention(q, k, v, causal=self.causal)
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return plain_attention(q, k, v, out_dtype=self.dtype, mask=mask,
                               bias=bias, causal=self.causal)

    def forward(self, x, mask=None, bias=None, pos=None):
        if pos is not None:
            _not_yet("decode positions", "A15")
        hd = self.head_dim
        q, k, v = self.qkv(x).split(
            [self.num_heads * hd, self.num_kv_heads * hd,
             self.num_kv_heads * hd], dim=-1)
        q, k, v = (t.unflatten(-1, (-1, hd)) for t in (q, k, v))
        out = self._attend(q, k, v, mask, bias=bias)
        return self.out(out.flatten(-2))


class TPMlp(nn.Module):
    """Column-parallel expansion, tanh gelu, row-parallel contraction."""

    def __init__(self, intermediate_size, hidden_size, dtype=torch.float32):
        super().__init__()
        setattr(self, "in", ColumnParallelDense(hidden_size, intermediate_size,
                                                dtype=dtype))
        self.out = RowParallelDense(intermediate_size, hidden_size,
                                    dtype=dtype)

    def forward(self, x):
        h = getattr(self, "in")(x)
        return self.out(F.gelu(h, approximate="tanh"))


class TPTransformerBlock(nn.Module):
    """Pre-LN block: x + attention(ln_attn(x)), then + mlp(ln_mlp(x))."""

    def __init__(self, num_heads, hidden_size, intermediate_size,
                 dtype=torch.float32, causal=False, use_flash=False,
                 sp_axis=None, decode=False):
        super().__init__()
        self.ln_attn = LayerNorm(hidden_size, dtype)
        self.attention = TPSelfAttention(
            num_heads, hidden_size, dtype=dtype, causal=causal,
            use_flash=use_flash, sp_axis=sp_axis, decode=decode)
        self.ln_mlp = LayerNorm(hidden_size, dtype)
        self.mlp = TPMlp(intermediate_size, hidden_size, dtype=dtype)

    def forward(self, x, mask=None, pos=None):
        x = x + self.attention(self.ln_attn(x), mask, pos=pos)
        return x + self.mlp(self.ln_mlp(x))

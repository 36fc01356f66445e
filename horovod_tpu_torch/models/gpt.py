"""GPT-style decoder-only LM in PyTorch.

Port of the JAX package's ``models/gpt.py`` (Flax): token plus learned
position embeddings, pre-LN transformer blocks from ``parallel/tp.py``, a
final LayerNorm and an fp32 ``lm_head`` with no bias and no weight tying;
``dtype`` activations over fp32 parameters. Attention in every block goes
through the flash kernels when ``config.use_flash`` is set.

Ported: the dense model, tensor parallelism (``tp_axis``: heads and MLP
columns sharded over the in-step axis, ``parallel/tp.py``), sequence
parallelism (``sp_axis``/``sp_impl``: token shards, ring or Ulysses
attention, the position table indexed at the shard's global positions),
MoE blocks (``num_experts > 0``: :class:`GPTMoEBlock` every
``moe_every``-th layer, experts over ``ep_axis``, ``parallel/moe.py``),
``features_only``, ``remat`` (each block under ``torch.utils.checkpoint``,
as ``nn.remat`` wraps it) and :func:`load_flax`, which fills any of the
port's Flax-named models from its Flax variable tree by name
(``load_flax_gpt``, ``load_flax_bert``, ``load_flax_llama``,
``load_flax_mlp`` and ``load_flax_vit`` are this one function), slicing the
tensor- and expert-parallel leaves for the rank's shard, and the decode
route: ``model(ids, pos=t, cache=cache)`` runs s tokens at position ``t``
(a host int, or a (B,) tensor of per-row positions) through a
``parallel/tp.py::DecodeCache`` of capacity ``max_position_embeddings``
(``models/generate.py::init_decode_cache``), the int8 cache with
``kv_cache_int8``. :func:`cache_from_flax` and :func:`cache_to_numpy`
carry a cache between JAX's Flax ``cache`` collection and the port.

The MoE blocks' load-balancing losses, which JAX sows into the
``losses/moe_aux`` collection, are the list ``model.moe_aux`` after each
forward: one scalar per MoE block, in layer order.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.parallel.moe import MoEMlp
from horovod_tpu_torch.parallel.tp import (ColumnParallelDense, Dense,
                                           DecodeCache, FlaxKernel,
                                           LayerNorm, RowParallelDense,
                                           TPSelfAttention,
                                           TPTransformerBlock, lecun_normal_,
                                           remat)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    num_experts: int = 0            # 0 -> dense MLP blocks only
    moe_k: int = 1
    capacity_factor: float = 2.0
    # The experts' 2-level dispatch over ep_axis: None asks the alltoall
    # registry (HOROVOD_HIERARCHICAL_ALLTOALL), True/False force it.
    moe_hierarchical: Optional[bool] = None
    dtype: Any = torch.float32
    tp_axis: Optional[str] = None   # "tp": heads and MLP sharded over it
    ep_axis: Optional[str] = None   # "ep": the MoE blocks' experts over it
    use_flash: bool = False         # the CUDA flash kernels (ops/kernels)
    sp_axis: Optional[str] = None   # sequence parallelism: tokens sharded
    sp_impl: str = "ring"           # "ring" | "ulysses" (parallel/sequence)
    remat: bool = False
    kv_cache_int8: bool = False     # the int8 decode cache (serving)

    @staticmethod
    def tiny(**kw):
        """For tests / dry runs."""
        base = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
                    intermediate_size=128, max_position_embeddings=64)
        base.update(kw)
        return GPTConfig(**base)


class GPTEmbed(nn.Module):
    """Token table cast to ``dtype``, plus the fp32 ``pos_emb[:L]`` cast to
    it; under a bound ``sp_axis`` of n > 1 shards, the table's rows at the
    shard's global positions. ``pos`` (decode): the position of the first
    of the L tokens, an int (rows ``pos..pos+L-1``), or a (B,) tensor, each
    row at its own position (the table gathered per row)."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.dtype = c.dtype
        self.sp_axis = c.sp_axis
        self.tok_emb = nn.Embedding(c.vocab_size, c.hidden_size)
        self.pos_emb = nn.Parameter(torch.empty(c.max_position_embeddings,
                                                c.hidden_size))

    def reset_parameters(self, generator=None):
        # flax.linen.Embed's default init: variance 1/features, truncated
        # normal; the position table is normal(0.02).
        lecun_normal_(self.tok_emb.weight, self.tok_emb.weight.shape[1],
                      generator)
        with torch.no_grad():
            self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids, pos=None):
        L = input_ids.shape[-1]
        cap = self.pos_emb.shape[0]
        if L > cap:
            raise ValueError(f"sequence {L} exceeds max_position_embeddings="
                             f"{cap}")
        tok = self.tok_emb(input_ids).to(self.dtype)
        if torch.is_tensor(pos) and pos.dim() == 1:     # per-row positions
            rows = pos.to(tok.device, torch.long)[:, None] + torch.arange(
                L, device=tok.device)
            return tok + self.pos_emb[rows].to(self.dtype)
        if pos is not None:
            pos = int(pos)
            if pos < 0 or pos + L > cap:
                raise ValueError(f"positions {pos}..{pos + L - 1} exceed "
                                 f"max_position_embeddings={cap}")
            return tok + self.pos_emb[pos:pos + L].to(self.dtype)[None]
        n_sp = in_step.axis_size_or_1(self.sp_axis)
        if n_sp > 1:
            if n_sp * L > self.pos_emb.shape[0]:
                raise ValueError(
                    f"global sequence {n_sp}x{L} exceeds "
                    f"max_position_embeddings={self.pos_emb.shape[0]}")
            off = in_step.axis_index(self.sp_axis) * L
            return tok + self.pos_emb[off:off + L].to(self.dtype)[None]
        return tok + self.pos_emb[:L].to(self.dtype)[None]


class GPTHead(nn.Module):
    """Final LayerNorm, then the fp32 lm_head (fp32 logits)."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.ln_f = LayerNorm(c.hidden_size, c.dtype)
        self.lm_head = Dense(c.hidden_size, c.vocab_size, use_bias=False,
                             dtype=torch.float32)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class GPTMoEBlock(nn.Module):
    """Pre-LN block: tensor-parallel causal attention, then the
    expert-parallel MoE FFN (experts over ``config.ep_axis``). Returns the
    hidden state alone (shape-invariant); the load-balancing loss of the
    last forward is ``self.aux``."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.ln_attn = LayerNorm(c.hidden_size, c.dtype)
        self.attention = TPSelfAttention(
            c.num_heads, c.hidden_size, dtype=c.dtype, causal=True,
            use_flash=c.use_flash, sp_axis=c.sp_axis, axis_name=c.tp_axis,
            sp_impl=c.sp_impl)
        self.ln_mlp = LayerNorm(c.hidden_size, c.dtype)
        self.moe = MoEMlp(c.num_experts, c.hidden_size, c.intermediate_size,
                          k=c.moe_k, capacity_factor=c.capacity_factor,
                          dtype=c.dtype, axis_name=c.ep_axis,
                          hierarchical=c.moe_hierarchical)
        self.aux = None

    def forward(self, x):
        x = x + self.attention(self.ln_attn(x))
        h, self.aux = self.moe(self.ln_mlp(x))
        return x + h


class GPT(nn.Module):
    """Embed -> ``num_layers`` blocks named ``layer_<i>`` -> head: dense
    blocks, and with ``config.num_experts`` a :class:`GPTMoEBlock` at each
    layer ``i`` with ``i % moe_every == moe_every - 1``. Parameters are
    drawn from ``generator`` with Flax's initializers. After a forward,
    ``moe_aux`` holds the MoE blocks' load-balancing losses in layer order
    (JAX's sown ``losses/moe_aux``). ``decode=True``: a model that runs
    the decode route alone (a cache on every call)."""

    def __init__(self, config, decode=False, generator=None, moe_every=2):
        super().__init__()
        c = config
        if decode and c.num_experts:
            raise ValueError("decode mode does not support MoE blocks")
        self.config = c
        self.decode = decode
        self.moe_every = moe_every
        self.embed = GPTEmbed(c)
        for i in range(c.num_layers):
            if c.num_experts and i % moe_every == moe_every - 1:
                block = GPTMoEBlock(c)
            else:
                block = TPTransformerBlock(
                    c.num_heads, c.hidden_size, c.intermediate_size,
                    dtype=c.dtype, causal=True, use_flash=c.use_flash,
                    sp_axis=c.sp_axis, axis_name=c.tp_axis,
                    sp_impl=c.sp_impl, cache_len=c.max_position_embeddings,
                    kv_cache_int8=c.kv_cache_int8)
            setattr(self, f"layer_{i}", block)
        self.head = GPTHead(c)
        self.moe_aux = []
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm, GPTEmbed, MoEMlp)):
                m.reset_parameters(generator)

    def forward(self, input_ids, pos=None, features_only=False, cache=None):
        """``input_ids`` (B, L) -> fp32 logits (B, L, vocab), or the pre-head
        hidden states (B, L, H) with ``features_only``. With ``cache`` (a
        ``DecodeCache``), the decode route: the L tokens at position
        ``pos`` (an int, or a (B,) tensor of per-row positions); without
        it ``pos`` is not read, as JAX's model outside decode mode."""
        decode = cache is not None
        if self.decode and not decode:
            raise ValueError("decode mode reads a decode cache: pass cache= "
                             "(generate.init_decode_cache)")
        if decode:
            if self.config.num_experts:
                raise ValueError("decode mode does not support MoE blocks")
            if pos is None:
                raise ValueError("decode mode requires pos (the token's "
                                 "global position)")
            cache = cache.for_feed()
        x = self.embed(input_ids, pos if decode else None)
        self.moe_aux = []
        for i in range(self.config.num_layers):
            block = getattr(self, f"layer_{i}")
            if decode:
                x = block(x, pos=pos, cache=cache.sub(f"layer_{i}"))
                continue
            x = remat(block, (x,)) if self.config.remat else block(x)
            if isinstance(block, GPTMoEBlock):
                self.moe_aux.append(block.aux)
        if features_only:
            return x
        return self.head(x)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "pos_emb": "pos_emb", "w_in": "w_in",
               "w_out": "w_out", "rel_bias": "rel_bias"}


def flax_key(path):
    """The port's parameter name of a Flax leaf path."""
    return ".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))


def tp_leaves(model, tp_rank=None, tp_size=None):
    """``{parameter name: (Flax axis, index, n)}`` for each tensor- or
    expert-parallel leaf of ``model``: a column-parallel kernel or bias is
    cut on its last Flax axis, a row-parallel kernel on its first, an MoE
    layer's ``w_in``/``w_out`` on the expert axis (its first). ``index``
    and ``n`` are the shard the layer was built for; ``tp_rank``/
    ``tp_size``, when given, must agree with a tensor-parallel one."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, MoEMlp) and m.shard_of is not None:
            for leaf in ("w_in", "w_out"):
                out[f"{name}.{leaf}" if name else leaf] = (0,) + m.shard_of
            continue
        if not isinstance(m, (ColumnParallelDense, RowParallelDense)) \
                or m.shard.shard_of is None:
            continue
        idx, n = m.shard.shard_of
        if (tp_rank is not None and tp_rank != idx) \
                or (tp_size is not None and tp_size != n):
            raise ValueError(f"{name} holds shard {idx} of {n}, not shard "
                             f"{tp_rank} of {tp_size}")
        if isinstance(m, RowParallelDense):
            out[f"{name}.shard.weight"] = (0, idx, n)
            continue
        for leaf in ("weight", "bias"):
            if getattr(m.shard, leaf) is not None:
                out[f"{name}.shard.{leaf}"] = (-1, idx, n)
    return out


def tp_slice(value, axis, idx, n):
    """Shard ``idx`` of ``n`` of a Flax leaf as JAX's ``out_specs`` lay a
    sharded one out: a plain cut (a fused leaf holds shard s's
    ``[q_s|k_s|v_s]`` side by side)."""
    return np.array_split(np.asarray(value), n, axis=axis)[idx]


def load_flax(model, variables, optimizer=None, powersgd_state=None,
              tp_rank=None, tp_size=None):
    """Fill ``model`` from the JAX package's variables of the same model
    (``{"params": ...}`` or the params tree itself, nested dicts of arrays
    under Flax's names), for every model whose modules carry Flax's names
    (GPT, BERT, LLaMA, the MLP, ViT, T5, VGG). Dense kernels go (in, out) ->
    (out, in), convolution kernels HWIO -> OIHW (``FlaxKernel``);
    LayerNorm and RMSNorm ``scale`` -> ``weight``; ``embedding`` ->
    ``weight``. A Flax leaf with no counterpart, a parameter with no Flax
    leaf, or a shape mismatch raises.

    Tensor parallelism: a model built inside a tp axis holds one shard of
    each column- and row-parallel layer, and takes its slice of the global
    Flax leaf (:func:`tp_leaves`, :func:`tp_slice`): ``tp_rank`` and
    ``tp_size`` are the shard's (by default the one its layers were built
    for); the fused QKV and gate_up leaves are in JAX's sharded layout
    (``[q_s|k_s|v_s] * n``). Expert parallelism likewise: an MoE layer
    built inside its ep axis takes its block of experts of JAX's global
    ``(E, d, f)`` ``w_in`` and ``(E, f, d)`` ``w_out``.

    ``powersgd_state``: the JAX PowerSGD transform's state, ``{"q": ...,
    "err": ...}`` with one entry per Flax leaf in ``tree_leaves`` order
    (sorted paths), as numpy; each compressed leaf's Q and residual go into
    ``optimizer.state[p]`` (a ``hvd.DistributedOptimizer`` with
    ``Compression.powersgd``) under its keys, in the Flax view, as the port
    keeps them."""
    params = variables.get("params", variables)
    targets = dict(model.named_parameters())
    sharded = tp_leaves(model, tp_rank, tp_size)
    filled = set()
    for path, value in _leaves(params):
        if path[-1] not in _LEAF_NAMES:
            raise KeyError(f"unexpected Flax leaf {'/'.join(path)}")
        key = flax_key(path)
        if key not in targets:
            raise KeyError(f"Flax leaf {'/'.join(path)} has no counterpart "
                           f"{key} in the module")
        if key in sharded:
            value = tp_slice(value, *sharded[key])
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
    if powersgd_state is not None:
        from horovod_tpu_torch.torch.optimizer import POWERSGD_ERR, POWERSGD_Q
        paths = sorted(path for path, _ in _leaves(params))
        for path, q, err in zip(paths, powersgd_state["q"],
                                powersgd_state["err"]):
            if not np.size(q):
                continue                 # an uncompressed leaf
            t = targets[flax_key(path)]
            err = np.asarray(err)          # in the leaf's or ef_dtype
            optimizer.state[t][POWERSGD_Q] = torch.from_numpy(
                np.array(q, dtype=np.float32)).to(t.device)
            optimizer.state[t][POWERSGD_ERR] = torch.from_numpy(
                err.astype(np.float32)).to(t.device, getattr(torch,
                                                             err.dtype.name))
    return model


def cache_from_flax(tree, device=None):
    """A ``DecodeCache`` holding JAX's Flax ``cache`` collection ``tree``
    (nested dicts of arrays, as ``decoder.apply(..., mutable=["cache"])``
    returns it): one entry per leaf, keyed by its path; JAX's (B, L, kv, d)
    K/V and (B, L, kv) scales in the port's (B, kv, L, ...) layout, bf16
    kept, ``idx`` a host int."""
    cache = DecodeCache()
    for path, leaf in _leaves(tree.get("cache", tree)):
        key = "/".join(path)
        arr = np.asarray(leaf)
        if path[-1] == "idx":
            cache.entries[key] = int(arr)
            continue
        dt = None
        if arr.dtype.name == "bfloat16":
            arr, dt = arr.astype(np.float32), torch.bfloat16
        t = torch.from_numpy(np.array(arr)).transpose(1, 2).contiguous()
        cache.entries[key] = t.to(device=device, dtype=dt)
    return cache


def cache_to_numpy(cache):
    """``cache``'s entries as JAX's Flax ``cache`` tree: nested dicts by
    path, numpy arrays in JAX's (B, L, kv, ...) layout (bf16 widened to
    fp32), ``idx`` an int32 scalar."""
    tree = {}
    for key, v in cache.entries.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if torch.is_tensor(v):
            v = v.detach().cpu().transpose(1, 2)
            node[leaf] = (v.float() if v.dtype == torch.bfloat16
                          else v).numpy()
        else:
            node[leaf] = np.asarray(v, np.int32)
    return tree


load_flax_gpt = load_flax

__all__ = ["GPTConfig", "GPTEmbed", "GPTHead", "GPTMoEBlock", "GPT",
           "load_flax", "load_flax_gpt", "tp_leaves", "tp_slice",
           "cache_from_flax", "cache_to_numpy"]

"""T5-style encoder-decoder in PyTorch: relative position biases, RMSNorm,
GEGLU, cross-attention.

Port of the JAX package's ``models/t5.py`` (Flax), the T5 1.1 recipe: one
token embedding shared by both stacks (``shared``), no absolute positions
(a learned per-head bias over bucketed relative positions, one table per
stack, shared across its layers), RMSNorm pre-norm, a gated-gelu MLP
(``TPSwiGLUMlp(activation="gelu")``), bias-free projections and an untied
fp32 ``lm_head``; ``dtype`` activations over fp32 parameters. The relative
bias is computed once per stack from a host-side numpy bucket matrix and
one table lookup, and keeps self-attention on the plain path (the flash
kernels take no additive bias), as in JAX; cross-attention is plain too.

Submodules carry Flax's names (``shared``, ``encoder``/``decoder``,
``layer_<i>`` with ``ln_attn``/``attention``/``ln_cross``/``cross``/
``ln_mlp``/``mlp``, ``rel_bias``, ``ln_f``, ``lm_head``), so
:func:`load_flax_t5` (``models/gpt.py::load_flax``) fills the model from a
Flax tree, slicing the tensor-parallel leaves for the rank's shard.

Decoding (:func:`t5_greedy_decode`, :func:`t5_generate`,
:func:`t5_beam_decode`) re-forwards the fixed-length target buffer each
step, or with ``use_cache=True`` feeds one token a step through the
decoder's self-attention caches (a ``parallel/tp.py::DecodeCache`` of
capacity ``max_decode_len``), the cross-attention K/V of the static memory
projected once (:meth:`T5.project_cross_kv`). A cached token's relative
bias is one row of the causal bucket matrix
(:func:`relative_position_buckets_causal_jnp` for every query position,
built on the host once and kept on the device), looked up in the table.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.generate import (_absorb_eos, _prompt,
                                               beam_expand, beam_finalize,
                                               beam_init_scores,
                                               beam_reorder_cache,
                                               beam_step_eos,
                                               check_sampling,
                                               init_decode_cache,
                                               sample_or_argmax)
from horovod_tpu_torch.models.gpt import load_flax
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.parallel.tp import (Dense, RMSNorm, TPCrossAttention,
                                           TPSelfAttention, TPSwiGLUMlp,
                                           remat, reset_flax_)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    hidden_size: int = 512
    num_layers: int = 8            # per stack (encoder AND decoder)
    num_heads: int = 8
    intermediate_size: int = 1024
    num_buckets: int = 32
    max_distance: int = 128
    max_decode_len: int = 512       # the decode cache's capacity
    rms_eps: float = 1e-6
    dtype: Any = torch.float32
    tp_axis: Optional[str] = "tp"
    remat: bool = False

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, num_buckets=8,
                    max_distance=16, max_decode_len=32)
        base.update(kw)
        return T5Config(**base)


def relative_position_buckets(query_len, key_len, num_buckets, max_distance,
                              bidirectional):
    """T5's bucketed relative positions, on the host: (Lq, Lk) int32.

    Half the buckets cover exact small offsets, the other half log-spaced
    offsets out to ``max_distance``; the encoder (bidirectional) splits the
    buckets again by sign. A copy of the JAX package's numpy function."""
    rel = np.arange(key_len)[None, :] - np.arange(query_len)[:, None]
    if bidirectional:
        num_buckets //= 2
        bucket_offset = (rel > 0).astype(np.int32) * num_buckets
        rel = np.abs(rel)
    else:
        bucket_offset = np.zeros_like(rel)
        rel = np.maximum(-rel, 0)      # the decoder attends to the past only
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int32)
    large = np.minimum(large, num_buckets - 1)
    return (bucket_offset + np.where(is_small, rel, large)).astype(np.int32)


def relative_position_buckets_causal_jnp(query_pos, key_positions,
                                         num_buckets, max_distance):
    """Causal buckets of ONE query position against a vector of key
    positions, on the host: JAX's traced decode-time function, in its fp32
    arithmetic (the log of an fp32 quotient, divided by the fp32 log of the
    distance ratio, times the log buckets, truncated), so a key at a
    bucket's edge falls on JAX's side of it. Future keys land in bucket 0
    (the cache's validity mask hides them). The name is JAX's."""
    rel = np.maximum(np.int32(query_pos) - np.asarray(key_positions,
                                                      np.int32), 0)
    max_exact = num_buckets // 2
    ratio = np.maximum(rel, 1).astype(np.float32) / np.float32(max_exact)
    large = max_exact + (np.log(ratio) / np.float32(
        np.log(max_distance / max_exact)) * np.float32(
            num_buckets - max_exact)).astype(np.int32)
    large = np.minimum(large, num_buckets - 1)
    return np.where(rel < max_exact, rel, large).astype(np.int32)


class T5RelativeBias(nn.Module):
    """A learned per-head bias over relative-position buckets (``rel_bias``,
    (num_buckets, num_heads), normal(0.1)), one table per stack. Heads are
    sharded over tp: the table stays replicated and the shard takes its
    heads by tp index, as ``TPSelfAttention`` lays its heads out."""

    def __init__(self, config, bidirectional):
        super().__init__()
        self.config = config
        self.bidirectional = bidirectional
        self.rel_bias = nn.Parameter(torch.empty(config.num_buckets,
                                                 config.num_heads))
        # (Lq, Lk, device) -> the bucket matrix on that device: built on the
        # host once, as JAX folds it into the trace as a constant, so a
        # forward makes no host-to-device copy (which would wait on the
        # stream).
        self._buckets = {}

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.rel_bias.normal_(0.0, 0.1, generator=generator)

    def _local_heads(self, bias):
        c = self.config
        n = in_step.axis_size_or_1(c.tp_axis)
        if n > 1:
            local = c.num_heads // n
            start = in_step.axis_index(c.tp_axis) * local
            bias = bias[start:start + local]
        return bias

    def forward(self, query_len, key_len):
        """(local heads, Lq, Lk) in ``config.dtype``."""
        c = self.config
        key = (query_len, key_len, self.rel_bias.device)
        buckets = self._buckets.get(key)
        if buckets is None:
            buckets = torch.from_numpy(relative_position_buckets(
                query_len, key_len, c.num_buckets, c.max_distance,
                self.bidirectional)).to(self.rel_bias.device, torch.long)
            self._buckets[key] = buckets
        # A lookup, not an index: the embedding's backward sums the
        # (Lq * Lk) gathered rows into the table in a fixed order on the
        # card, where an indexing backward may add them atomically.
        bias = F.embedding(buckets, self.rel_bias.to(c.dtype))
        return self._local_heads(bias.permute(2, 0, 1))

    def decode_bias(self, pos, cache_len):
        """The bias row of ONE query at position ``pos`` against cache slots
        0..cache_len-1 (causal stacks): (local heads, 1, cache_len). The
        (cache_len, cache_len) bucket matrix is built on the host once per
        (cache_len, device) and kept there; a token indexes its row."""
        c = self.config
        key = ("decode", cache_len, self.rel_bias.device)
        buckets = self._buckets.get(key)
        if buckets is None:
            keys = np.arange(cache_len)
            buckets = torch.from_numpy(np.stack([
                relative_position_buckets_causal_jnp(
                    q, keys, c.num_buckets, c.max_distance)
                for q in range(cache_len)])).to(self.rel_bias.device,
                                                torch.long)
            self._buckets[key] = buckets
        bias = F.embedding(buckets[pos], self.rel_bias.to(c.dtype))
        return self._local_heads(bias.t()[:, None, :])


class T5Block(nn.Module):
    """Pre-RMSNorm block: self-attention with the relative bias, in the
    decoder cross-attention over the encoder's memory, then the GEGLU MLP;
    no biases. ``cross_kv`` (from ``project_kv_only``) replaces the cross
    K/V projection of a static memory. With ``cache`` (this block's view of
    a decode cache), the self-attention decodes one token at the cache's
    cursor, ``bias`` its relative-position row over the cache."""

    def __init__(self, config, causal, cross, decode=False):
        super().__init__()
        c = config
        self.ln_attn = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.attention = TPSelfAttention(
            c.num_heads, c.hidden_size, dtype=c.dtype, causal=causal,
            use_bias=False, axis_name=c.tp_axis, decode=decode,
            cache_len=c.max_decode_len)
        if cross:
            self.ln_cross = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
            self.cross = TPCrossAttention(c.num_heads, c.hidden_size,
                                          dtype=c.dtype, axis_name=c.tp_axis,
                                          use_bias=False)
        self.has_cross = cross
        self.ln_mlp = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.mlp = TPSwiGLUMlp(c.intermediate_size, c.hidden_size,
                               dtype=c.dtype, activation="gelu",
                               axis_name=c.tp_axis)

    def forward(self, x, bias, memory=None, memory_mask=None, mask=None,
                cross_kv=None, project_kv_only=False, cache=None):
        if project_kv_only:
            return self.cross(None, memory, project_only=True)
        x = x + self.attention(self.ln_attn(x), mask, bias,
                               cache=None if cache is None
                               else cache.sub("attention"))
        if self.has_cross:
            x = x + self.cross(self.ln_cross(x), memory, memory_mask,
                               cached_kv=cross_kv)
        return x + self.mlp(self.ln_mlp(x))


def _embedding(stack, embed, config):
    """Register a standalone stack's own ``tok_emb``, or keep the parent's
    shared embedding out of the stack's parameters (T5 holds it once,
    under ``shared``)."""
    if embed is None:
        stack.tok_emb = nn.Embedding(config.vocab_size, config.hidden_size)
        stack._shared = None
    else:
        stack._shared = (embed,)        # a tuple: not registered here


def _embed(stack, ids):
    emb = stack.tok_emb if stack._shared is None else stack._shared[0]
    return emb(ids).to(stack.config.dtype)


class T5Encoder(nn.Module):
    """Encoder stack: bidirectional self-attention blocks ``layer_<i>`` over
    one relative bias, then ``ln_f``. ``embed``: the parent :class:`T5`'s
    shared token embedding; standalone, the stack has its own."""

    def __init__(self, config, embed=None):
        super().__init__()
        c = self.config = config
        _embedding(self, embed, c)
        self.rel_bias = T5RelativeBias(c, bidirectional=True)
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", T5Block(c, causal=False,
                                                cross=False))
        self.ln_f = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)

    def forward(self, input_ids, mask=None):
        c = self.config
        x = _embed(self, input_ids)
        L = input_ids.shape[1]
        bias = self.rel_bias(L, L)
        for i in range(c.num_layers):
            block = getattr(self, f"layer_{i}")
            x = remat(lambda h, b=block: b(h, bias, mask=mask), (x,)) \
                if c.remat else block(x, bias, mask=mask)
        return self.ln_f(x)


class T5Decoder(nn.Module):
    """Decoder stack: causal self-attention over one relative bias,
    cross-attention over the memory, ``ln_f`` and the untied fp32
    ``lm_head``. ``project_kv_only`` returns each layer's fused cross K/V
    of ``memory``. With ``cache``, ONE token a call at position ``pos``
    through the layers' self-attention caches; ``decode=True``: a stack
    that runs that route alone."""

    def __init__(self, config, embed=None, decode=False):
        super().__init__()
        self.decode = decode
        c = self.config = config
        _embedding(self, embed, c)
        self.rel_bias = T5RelativeBias(c, bidirectional=False)
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", T5Block(c, causal=True, cross=True,
                                                decode=decode))
        self.ln_f = RMSNorm(c.hidden_size, c.dtype, c.rms_eps)
        self.lm_head = Dense(c.hidden_size, c.vocab_size, use_bias=False,
                             dtype=torch.float32)

    def forward(self, input_ids, memory, memory_mask=None, pos=None,
                cross_kv=None, project_kv_only=False, cache=None):
        c = self.config
        blocks = [getattr(self, f"layer_{i}") for i in range(c.num_layers)]
        if project_kv_only:
            return tuple(b(None, None, memory=memory, project_kv_only=True)
                         for b in blocks)
        decode = cache is not None
        if self.decode and not decode:
            raise ValueError("decode mode reads a decode cache: pass cache= "
                             "(generate.init_decode_cache)")
        if decode and pos is None:
            raise ValueError("decode mode requires pos (the token's "
                             "position)")
        x = _embed(self, input_ids)
        if decode:
            cache = cache.for_feed()
            bias = self.rel_bias.decode_bias(pos, c.max_decode_len)
        else:
            L = input_ids.shape[1]
            bias = self.rel_bias(L, L)
        for i, block in enumerate(blocks):
            ckv = None if cross_kv is None else cross_kv[i]
            if decode:
                x = block(x, bias, memory=memory, memory_mask=memory_mask,
                          cross_kv=ckv, cache=cache.sub(f"layer_{i}"))
                continue

            def run(h, b=block, ckv=ckv):
                return b(h, bias, memory=memory, memory_mask=memory_mask,
                         cross_kv=ckv)
            x = remat(run, (x,)) if c.remat else run(x)
        return self.lm_head(self.ln_f(x))


class T5(nn.Module):
    """Encoder-decoder LM: ``(src_ids, tgt_ids) -> (B, Lt, V)`` fp32 logits.
    ``src_mask`` (B, Ls), True on valid source tokens, masks the encoder's
    self-attention and the decoder's cross-attention. Parameters are drawn
    from ``generator`` with Flax's initializers. ``decode_mode=True``: a
    decoder that runs the cached route alone."""

    def __init__(self, config, decode_mode=False, generator=None):
        super().__init__()
        c = self.config = config
        self.decode_mode = decode_mode
        self.shared = nn.Embedding(c.vocab_size, c.hidden_size)
        self.encoder = T5Encoder(c, embed=self.shared)
        self.decoder = T5Decoder(c, embed=self.shared, decode=decode_mode)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        reset_flax_(self, generator)
        for m in self.modules():
            if isinstance(m, T5RelativeBias):
                m.reset_parameters(generator)

    def encode(self, src_ids, src_mask=None):
        return self.encoder(src_ids, src_mask)

    def decode(self, tgt_ids, memory, memory_mask=None, pos=None,
               cross_kv=None, cache=None):
        """The decoder; with ``cache`` (``init_decode_cache(model, B)``),
        one token at position ``pos`` through its caches."""
        return self.decoder(tgt_ids, memory, memory_mask=memory_mask,
                            pos=pos, cross_kv=cross_kv,
                            cache=None if cache is None
                            else cache.sub("decoder"))

    def project_cross_kv(self, memory):
        """Each decoder layer's fused cross-attention K/V of the (static)
        encoder memory: project once, pass to :meth:`decode` as
        ``cross_kv``."""
        return self.decoder(None, memory, project_kv_only=True)

    def forward(self, src_ids, tgt_ids, src_mask=None):
        return self.decode(tgt_ids, self.encode(src_ids, src_mask),
                           memory_mask=src_mask)


# ---------------------------------------------------------------------------
# Decoding: the encoder once, the decoder re-forwarding the target buffer
# ---------------------------------------------------------------------------

@torch.no_grad()
def _t5_greedy(model, src_ids, max_len, bos_id, src_mask, eos_id,
               temperature, rng, top_k, top_p):
    memory = model.encode(src_ids, src_mask)
    B = src_ids.shape[0]
    buf = torch.full((B, max_len), bos_id, dtype=torch.long,
                     device=src_ids.device)
    done = torch.zeros(B, dtype=torch.bool, device=src_ids.device)
    for t in range(1, max_len):
        logits = model.decode(buf, memory, memory_mask=src_mask)
        nxt = sample_or_argmax(logits[:, t - 1], rng, temperature, top_k,
                               top_p)
        nxt, done = _absorb_eos(nxt, done, eos_id)
        buf[:, t] = nxt
    return buf


@torch.no_grad()
def _t5_beam(model, src_ids, max_len, num_beams, bos_id, src_mask, eos_id,
             length_penalty):
    memory = model.encode(src_ids, src_mask)
    B, k = src_ids.shape[0], num_beams
    mem_k = memory.repeat_interleave(k, dim=0)
    mask_k = None if src_mask is None else src_mask.repeat_interleave(k, 0)
    dev = src_ids.device
    bufs = torch.full((B, k, max_len), bos_id, dtype=torch.long, device=dev)
    scores = beam_init_scores(B, k, dev)
    fin_bufs = torch.zeros_like(bufs)
    fin_scores = torch.full((B, k), -torch.inf, device=dev)
    for t in range(1, max_len):
        logits = model.decode(bufs.reshape(B * k, max_len), mem_k,
                              memory_mask=mask_k)
        logp = torch.log_softmax(logits[:, t - 1].float(), dim=-1).reshape(
            B, k, -1)
        if eos_id is None:
            bufs, scores, _ = beam_expand(logp, bufs, scores, t)
        else:
            bufs, scores, fin_bufs, fin_scores, _ = beam_step_eos(
                logp, bufs, scores, fin_bufs, fin_scores, t, 1, eos_id,
                length_penalty)
    return beam_finalize(bufs, scores, fin_bufs, fin_scores, 1, eos_id,
                         length_penalty)


@torch.no_grad()
def _t5_greedy_cached(model, cache, src_ids, max_len, bos_id, src_mask,
                      eos_id, temperature, rng, top_k, top_p):
    """The encoder once, the cross K/V of its memory projected once, then
    ONE decoder token a step through the self-attention caches."""
    memory = model.encode(src_ids, src_mask)
    cross_kv = model.project_cross_kv(memory)
    B = src_ids.shape[0]
    buf = torch.full((B, max_len), bos_id, dtype=torch.long,
                     device=src_ids.device)
    done = torch.zeros(B, dtype=torch.bool, device=src_ids.device)
    for t in range(1, max_len):
        logits = model.decode(buf[:, t - 1:t], memory, memory_mask=src_mask,
                              pos=t - 1, cross_kv=cross_kv, cache=cache)
        nxt = sample_or_argmax(logits[:, 0], rng, temperature, top_k, top_p)
        nxt, done = _absorb_eos(nxt, done, eos_id)
        buf[:, t] = nxt
    return buf


@torch.no_grad()
def _t5_beam_cached(model, cache, src_ids, max_len, num_beams, bos_id,
                    src_mask, eos_id, length_penalty):
    """The cached seq2seq beam search: the encoder once at batch B, its
    cross K/V projected once and repeated per beam (the memory itself is
    not: with the K/V given, the decoder never reads it), then ONE token a
    hypothesis a step, the self-attention caches (at B * k) reordered by
    beam origin after each expansion but the last."""
    B, k = src_ids.shape[0], num_beams
    memory = model.encode(src_ids, src_mask)
    ckv_k = tuple(c.repeat_interleave(k, dim=0)
                  for c in model.project_cross_kv(memory))
    mask_k = None if src_mask is None else src_mask.repeat_interleave(k, 0)
    dev = src_ids.device
    bufs = torch.full((B, k, max_len), bos_id, dtype=torch.long, device=dev)
    scores = beam_init_scores(B, k, dev)
    fin_bufs = torch.zeros_like(bufs)
    fin_scores = torch.full((B, k), -torch.inf, device=dev)
    for t in range(1, max_len):
        tok = bufs.reshape(B * k, max_len)[:, t - 1:t]
        logits = model.decode(tok, memory, memory_mask=mask_k, pos=t - 1,
                              cross_kv=ckv_k, cache=cache)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(
            B, k, -1)
        if eos_id is None:
            bufs, scores, origin = beam_expand(logp, bufs, scores, t)
        else:
            bufs, scores, fin_bufs, fin_scores, origin = beam_step_eos(
                logp, bufs, scores, fin_bufs, fin_scores, t, 1, eos_id,
                length_penalty)
        if t < max_len - 1:
            cache = beam_reorder_cache(cache, origin, B, k)
    return beam_finalize(bufs, scores, fin_bufs, fin_scores, 1, eos_id,
                         length_penalty)


def _check_decode_capacity(model, max_len):
    cap = model.config.max_decode_len
    if max_len > cap:
        raise ValueError(f"max_len {max_len} exceeds the decode cache "
                         f"capacity (max_decode_len={cap})")


def t5_beam_decode(model, src_ids, max_len, num_beams=4, bos_id=0,
                   src_mask=None, eos_id=None, length_penalty=0.0,
                   use_cache=False):
    """Beam-search seq2seq decoding: the encoder once, then ``num_beams``
    hypotheses re-forwarded together each step (a fixed-length buffer).
    Returns ``(sequences, scores)``: (B, max_len) token ids starting with
    ``bos_id`` and the summed token log-probs. ``num_beams=1`` with no EOS
    equals :func:`t5_greedy_decode`. ``eos_id``/``length_penalty``: the
    finished pool with GNMT length normalisation, as in
    :func:`horovod_tpu_torch.models.generate.beam_search`.
    ``use_cache=True``: the cached beam decode (cross K/V projected once,
    the self-attention caches reordered by beam origin; ``max_len`` at
    most ``config.max_decode_len``), the re-forward search's sequences."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if max_len < 2:
        raise ValueError(f"max_len must be >= 2, got {max_len}")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0, got {length_penalty}")
    src_ids = _prompt(model, src_ids)
    args = (int(max_len), int(num_beams), int(bos_id), src_mask,
            None if eos_id is None else int(eos_id), float(length_penalty))
    if use_cache:
        _check_decode_capacity(model, max_len)
        cache = init_decode_cache(model, src_ids.shape[0] * int(num_beams))
        return _t5_beam_cached(model, cache, src_ids, *args)
    return _t5_beam(model, src_ids, *args)


def t5_generate(model, src_ids, max_len, bos_id=0, src_mask=None,
                use_cache=False, eos_id=None, temperature=0.0, rng=None,
                top_k=0, top_p=1.0):
    """Seq2seq decoding with the causal family's sampling controls:
    ``temperature=0`` is greedy (== :func:`t5_greedy_decode`); otherwise a
    tempered categorical draw from ``rng`` (a ``torch.Generator`` on the
    model's device) with optional top-k / nucleus filtering. ``eos_id``
    finishes rows as in :func:`horovod_tpu_torch.models.generate.generate`,
    on the re-forward or (``use_cache``) the cached route, which draw one
    stream from one seed."""
    check_sampling(temperature, rng, top_k, top_p)
    return _t5_decode(model, src_ids, max_len, bos_id, src_mask, use_cache,
                      eos_id, float(temperature), rng, int(top_k),
                      float(top_p))


def t5_greedy_decode(model, src_ids, max_len, bos_id=0, src_mask=None,
                     use_cache=False, eos_id=None):
    """Greedy seq2seq decoding: the encoder once, then the decoder
    re-forwards the fixed-length buffer each step (its causal structure
    ignores the tail not yet written); ``use_cache=True`` decodes one token
    a step through the decoder's caches instead (``max_len`` at most
    ``config.max_decode_len``), with the same tokens. Returns (B, max_len)
    token ids starting with ``bos_id``."""
    return _t5_decode(model, src_ids, max_len, bos_id, src_mask, use_cache,
                      eos_id, 0.0, None, 0, 1.0)


def _t5_decode(model, src_ids, max_len, bos_id, src_mask, use_cache,
               eos_id, temperature, rng, top_k, top_p):
    src_ids = _prompt(model, src_ids)
    args = (int(max_len), int(bos_id), src_mask,
            None if eos_id is None else int(eos_id), temperature, rng, top_k,
            top_p)
    if use_cache:
        _check_decode_capacity(model, max_len)
        return _t5_greedy_cached(
            model, init_decode_cache(model, src_ids.shape[0]), src_ids,
            *args)
    return _t5_greedy(model, src_ids, *args)


load_flax_t5 = load_flax

__all__ = ["T5Config", "T5RelativeBias", "T5Block", "T5Encoder",
           "T5Decoder", "T5", "relative_position_buckets",
           "relative_position_buckets_causal_jnp", "t5_greedy_decode",
           "t5_generate", "t5_beam_decode", "load_flax_t5"]

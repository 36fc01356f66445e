"""Autoregressive generation for the port's causal LMs (GPT, LLaMA, the MoE
GPT): greedy and sampled decoding and beam search.

Port of the JAX package's ``models/generate.py``. JAX compiles each loop
into one program; here it is an eager Python loop under
``torch.no_grad()``, with the model's own kernels.

- The re-forward route (the default): each step runs the model on the
  whole fixed-length buffer (static shapes; the causal structure ignores
  the tail not yet written), one forward per generated token, through the
  flash kernels when the model has ``use_flash``.
- The cached route (``use_cache=True``; dense GPT and LLaMA): one forward
  of s tokens per feed against a ``parallel/tp.py::DecodeCache``
  (:func:`init_decode_cache`), the prompt prefilled in chunks of up to 512
  tokens; beam search reorders the cache by beam origin after each
  expansion (:func:`beam_reorder_cache`), and :func:`prefill_prefix` keeps
  a shared prefix's cache for later calls (``prefix_state``). The cached
  attend is plain PyTorch, as JAX leaves its cached attend to XLA.

Sampling takes a ``torch.Generator`` (``rng``, on the logits' device) where
JAX takes a PRNG key: the same seed gives the same stream, but not JAX's
stream; the cached and re-forward routes draw the same stream. Greedy
decoding and beam search draw nothing and follow JAX's tokens.
"""

import numpy as np
import torch

from horovod_tpu_torch.parallel.tp import DecodeCache, TPSelfAttention


def _filter_logits(logits, top_k, top_p):
    """Top-k / nucleus filtering on (B, V) logits (no-ops at k = 0 / p = 1).
    Masked entries get -1e30, so a categorical draw never picks them."""
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    if top_k:
        k = min(top_k, logits.shape[-1])   # top_k past V keeps everything
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # the smallest prefix whose mass reaches top_p (always >= 1 entry)
        keep = cum - probs < top_p
        thresh = torch.where(keep, srt, torch.inf).min(dim=-1,
                                                       keepdim=True).values
        logits = torch.where(logits >= thresh.to(logits.dtype), logits, neg)
    return logits


def _absorb_eos(nxt, done, eos_id):
    """Fixed-length EOS semantics: a finished row keeps emitting EOS and its
    ``done`` flag latches. ``eos_id=None``: no EOS."""
    if eos_id is None:
        return nxt, done
    nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    return nxt, done | (nxt == eos_id)


def categorical(probs, rng):
    """One draw per row of (B, V) ``probs`` from ``rng``."""
    return torch.multinomial(probs, 1, generator=rng)[:, 0]


def sample_or_argmax(logits, rng, temperature, top_k, top_p):
    """The next token from (B, V) logits, for every decode path: argmax at
    temperature 0, else a tempered categorical draw from ``rng`` over the
    top-k / nucleus filtered distribution (tempered before filtering).
    The generator carries its own state, so no key comes back."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filtered = _filter_logits(logits.float() / temperature, top_k, top_p)
    return categorical(torch.softmax(filtered, dim=-1), rng)


def check_sampling(temperature, rng, top_k, top_p):
    """The sampling controls' ``ValueError``s, as JAX raises them."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"need top_k >= 0 and 0 < top_p <= 1, got "
                         f"top_k={top_k}, top_p={top_p}")
    if temperature != 0.0 and rng is None:
        raise ValueError("sampling (temperature != 0) requires rng")


def _check_position_capacity(model, max_len):
    """Fail loudly when ``max_len`` exceeds the model's position table
    (``config.max_position_embeddings``, where the model has one), on every
    decode route: the cache's capacity is that table's, and a write past it
    raises rather than clamping onto the last rows as JAX's
    ``dynamic_update_slice`` would."""
    cap = getattr(getattr(model, "config", None),
                  "max_position_embeddings", None)
    if cap is not None and max_len > cap:
        raise ValueError(
            f"max_len {max_len} exceeds the model's position capacity "
            f"(max_position_embeddings={cap})")


def _prompt(model, prompt):
    """``prompt`` (numpy or a tensor) as int64 ids on the model's device."""
    dev = next(model.parameters()).device
    if not torch.is_tensor(prompt):
        prompt = torch.from_numpy(np.asarray(prompt))
    return prompt.to(dev, torch.long)


# ---------------------------------------------------------------------------
# The decode cache
# ---------------------------------------------------------------------------

def init_decode_cache(model, batch, device=None):
    """A zeroed ``DecodeCache`` for ``batch`` rows of ``model``: every causal
    ``TPSelfAttention`` with a capacity (``cache_len``: GPT's and LLaMA's
    ``max_position_embeddings``, T5's decoder's ``max_decode_len``) gets its
    K/V (and int8 scales) at full capacity and its cursor at 0, under its
    module path (``layer_0/attention``, T5's ``decoder/layer_0/attention``),
    as JAX's cache tree nests them. ``device``: the model's by default."""
    if device is None:
        device = next(model.parameters()).device
    cache = DecodeCache()
    for name, m in model.named_modules():
        if isinstance(m, TPSelfAttention) and m.causal and m.cache_len > 0:
            m.init_cache(cache.sub(name.replace(".", "/")), batch, device)
    if not cache.entries:
        raise ValueError(f"{type(model).__name__} has no causal attention "
                         f"with a decode cache capacity")
    return cache


def _decode_feed(model):
    """One cached feed of a (B, s) chunk at position ``t``: returns the cache
    (written in place) and the FIRST fed token's next-token logits (B, V)."""

    def feed(cache, tok, t):
        return cache, model(tok, pos=t, cache=cache)[:, 0]

    return feed


def _chunk_feed(model):
    """A cached feed returning every one of the s logit rows (B, s, V): the
    chunked prefill, prefix caching and the speculative verifier."""

    def feed(cache, toks, t):
        return cache, model(toks, pos=t, cache=cache)

    return feed


def _prefill_cache(feed, cache, prompt, chunk=512, start=0, end=None):
    """Teacher-force prompt tokens ``[start, end)`` into the cache in feeds
    of up to ``chunk`` tokens (the score transient stays (B, heads, chunk,
    capacity)); ``end`` defaults to P - 1, the last prompt token being the
    first decode step's input. The logits are dropped."""
    end = prompt.shape[1] - 1 if end is None else end
    for s in range(start, end, chunk):
        cache, _ = feed(cache, prompt[:, s:min(s + chunk, end)], s)
    return cache


@torch.no_grad()
def prefill_prefix(model, prefix):
    """The decode cache of a fixed prompt prefix (the shared system prompt):
    all ``Pp`` tokens fed once, for ``generate(..., use_cache=True,
    prefix_state=state)`` to start from; each call copies it, so the state
    serves any number of calls. ``prefix``: (B, Pp), or (1, Pp) to tile to
    any batch. Returns ``{"cache", "len", "prefix"}``."""
    prefix = _prompt(model, prefix)
    _check_position_capacity(model, prefix.shape[1])
    cache = init_decode_cache(model, prefix.shape[0])
    cache = _prefill_cache(_chunk_feed(model), cache, prefix,
                           end=prefix.shape[1])
    return {"cache": cache, "len": int(prefix.shape[1]), "prefix": prefix}


@torch.no_grad()
def _generate_cached(model, cache, prompt, max_len, temperature, rng,
                     top_k, top_p, eos_id, prefill_start=0):
    """The cached decode: the prompt (after ``prefill_start`` tokens the
    cache already holds) prefilled without sampling, so the generator's
    stream stays the re-forward route's, then one token a feed."""
    B, P = prompt.shape
    buf = torch.zeros((B, max_len), dtype=torch.long, device=prompt.device)
    buf[:, :P] = prompt
    feed = _decode_feed(model)
    cache = _prefill_cache(feed, cache, prompt, start=prefill_start)
    done = torch.zeros(B, dtype=torch.bool, device=prompt.device)
    for t in range(P - 1, max_len - 1):
        cache, logits = feed(cache, buf[:, t:t + 1], t)
        nxt = sample_or_argmax(logits, rng, temperature, top_k, top_p)
        nxt, done = _absorb_eos(nxt, done, eos_id)
        buf[:, t + 1] = nxt
    return buf


@torch.no_grad()
def _generate(model, prompt, max_len, temperature, rng, top_k, top_p,
              eos_id):
    B, P = prompt.shape
    buf = torch.zeros((B, max_len), dtype=torch.long, device=prompt.device)
    buf[:, :P] = prompt
    done = torch.zeros(B, dtype=torch.bool, device=prompt.device)
    # Positions < P are the prompt: one forward per GENERATED token.
    for t in range(P, max_len):
        logits = model(buf)                 # (B, max_len, V)
        # logits at position t-1 predict token t
        nxt = sample_or_argmax(logits[:, t - 1], rng, temperature, top_k,
                               top_p)
        nxt, done = _absorb_eos(nxt, done, eos_id)
        buf[:, t] = nxt
    return buf


def generate(model, prompt, max_len, temperature=0.0, rng=None,
             use_cache=False, top_k=0, top_p=1.0, eos_id=None,
             prefix_state=None):
    """Generate up to ``max_len`` total tokens from ``prompt``.

    - ``model``: a causal LM whose ``model(ids)`` returns next-token logits
      ``(B, L, V)`` (GPT, LLaMA, the MoE GPT) with
      ``max_position_embeddings >= max_len``.
    - ``prompt``: (B, P) token ids, P <= max_len.
    - ``temperature``: 0 -> greedy argmax; otherwise a categorical draw
      from ``rng``, a ``torch.Generator`` on the model's device.
    - ``top_k`` / ``top_p``: sampling filters (0 / 1.0 = off).
    - ``eos_id``: once a row GENERATES it, the row pads with ``eos_id`` to
      ``max_len``; EOS tokens inside the prompt do not count.
    - ``use_cache``: the cached decode (dense GPT and LLaMA), one token a
      feed against the decode cache; the same tokens as the re-forward
      route, and for one generator seed the same sampled stream.
    - ``prefix_state`` (with ``use_cache``): a :func:`prefill_prefix`
      result; only the prompt tokens after the prefix are prefilled.
      ``prompt`` carries the whole sequence and must begin with the prefix
      (checked); a (1, Pp) prefix tiles to the batch.

    Returns (B, max_len) int64 token ids: the prompt, then the generated
    tokens."""
    B, P = prompt.shape
    if not 1 <= P <= max_len:
        raise ValueError(
            f"prompt length {P} must be in [1, max_len={max_len}] "
            "(position 0 must come from the prompt)")
    check_sampling(temperature, rng, top_k, top_p)
    _check_position_capacity(model, max_len)
    if prefix_state is not None and not use_cache:
        raise ValueError("prefix_state requires use_cache=True (the "
                         "prefix lives in the decode cache)")
    prompt = _prompt(model, prompt)
    eos = None if eos_id is None else int(eos_id)
    if not use_cache:
        return _generate(model, prompt, int(max_len), float(temperature),
                         rng, int(top_k), float(top_p), eos)
    start = 0
    if prefix_state is None:
        cache = init_decode_cache(model, B)
    else:
        start, pfx = int(prefix_state["len"]), prefix_state["prefix"]
        if start >= P:
            # The prefix cache's cursor sits past its last token, and the
            # decode loop feeds prompt[:, P-1] again: a duplicate row.
            raise ValueError(
                f"prefix length {start} must be SHORTER than the prompt "
                f"({P}): the last prompt token is the first decode input")
        if pfx.shape[0] not in (1, B):
            raise ValueError(f"prefix batch {pfx.shape[0]} incompatible "
                             f"with prompt batch {B} (use 1 or {B})")
        if not torch.equal(prompt[:, :start],
                           pfx.to(prompt.device).expand(B, start)):
            raise ValueError(
                "prompt does not begin with the prefix the prefix_state was "
                "built from: the cached K/V rows would describe other text")
        tile = pfx.shape[0] == 1 and B > 1
        cache = prefix_state["cache"].map(
            (lambda t: t.repeat_interleave(B, dim=0)) if tile
            else torch.clone)
    return _generate_cached(model, cache, prompt, int(max_len),
                            float(temperature), rng, int(top_k),
                            float(top_p), eos, start)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def beam_init_scores(B, k, device=None):
    """All beams start identical: only beam 0 may seed the first expansion,
    or the top-k would fill with k copies of one hypothesis."""
    scores = torch.where(torch.arange(k, device=device) == 0, 0.0,
                         -torch.inf)
    return scores[None].expand(B, k).float().clone()


def beam_expand(logp, bufs, scores, t):
    """One beam expansion, shared by the causal and seq2seq searches: a
    joint (beam, token) top-k over ``scores + logp``, the beams reordered by
    origin, the chosen tokens written at position ``t``. ``logp``: (B, k, V)
    next-token log-probs; ``bufs``: (B, k, L). Returns ``(bufs, scores,
    origin)``, ``origin[b, j]`` the beam the new beam j continues."""
    B, k, V = logp.shape
    cand = (scores[:, :, None] + logp).reshape(B, k * V)
    scores, idx = torch.topk(cand, k, dim=-1)
    beam, tok = idx // V, idx % V
    bufs = bufs.gather(1, beam[:, :, None].expand(-1, -1, bufs.shape[-1]))
    bufs[:, :, t] = tok
    return bufs, scores, beam


def beam_best(bufs, scores):
    """The best hypothesis of each batch row: ((B, L), (B,))."""
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(bufs.shape[0], device=bufs.device)
    return bufs[rows, best], scores[rows, best]


def beam_step_eos(logp, bufs, scores, fin_bufs, fin_scores, t, prompt_len,
                  eos_id, length_penalty):
    """One beam expansion with a finished-hypothesis pool (k live and k
    finished slots), shared by the causal and seq2seq searches: each live
    beam's finish-now candidate (its score plus the EOS log-prob,
    GNMT-normalised by the generated length with the EOS) merges into the
    pool by top-k over the 2k candidates, so a finished hypothesis is never
    evicted by later live expansions; the live beams then expand with the
    EOS column masked out."""
    B, k, V = logp.shape
    L = bufs.shape[-1]
    fin_cand = scores + logp[:, :, eos_id]                   # (B, k)
    if length_penalty:
        gen_len = torch.tensor(float(max(t - prompt_len + 1, 1)),
                               dtype=torch.float32, device=logp.device)
        fin_cand = fin_cand / gen_len ** length_penalty
    # the finished buffer: the hypothesis so far, EOS-padded from t on
    pos = torch.arange(L, device=bufs.device)
    cand_bufs = torch.where(pos[None, None, :] >= t,
                            torch.full_like(bufs, eos_id), bufs)
    all_scores = torch.cat([fin_scores, fin_cand], dim=1)    # (B, 2k)
    all_bufs = torch.cat([fin_bufs, cand_bufs], dim=1)
    fin_scores, idx = torch.topk(all_scores, k, dim=-1)
    fin_bufs = all_bufs.gather(1, idx[:, :, None].expand(-1, -1, L))
    live_logp = logp.clone()
    live_logp[:, :, eos_id] = -torch.inf
    bufs, scores, origin = beam_expand(live_logp, bufs, scores, t)
    return bufs, scores, fin_bufs, fin_scores, origin


def beam_finalize(bufs, scores, fin_bufs, fin_scores, prompt_len, eos_id,
                  length_penalty):
    """The best hypothesis of each row across the live beams (normalised by
    the whole generated span) and the finished pool (normalised when each
    finished). Without an EOS the pool is empty."""
    B, k, L = bufs.shape
    if length_penalty:
        scores = scores / float(max(L - prompt_len, 1)) ** length_penalty
    if eos_id is None:
        return beam_best(bufs, scores)
    return beam_best(torch.cat([fin_bufs, bufs], dim=1),
                     torch.cat([fin_scores, scores], dim=1))


def beam_reorder_cache(cache, origin, B, k):
    """The decode cache's rows reordered so each new beam holds its origin
    beam's history (the causal and seq2seq cached searches): every tensor
    whose leading dim is B * k is gathered by ``b * k + origin[b, j]``
    into the cache's spare buffer of its shape, and the two swap, so a
    step allocates nothing; the cursors are shared by the beams. Returns
    ``cache``."""
    Bk = B * k
    flat = (torch.arange(B, device=origin.device)[:, None] * k
            + origin).reshape(Bk)
    for path, t in cache.items():
        if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == Bk:
            spare = cache.spare(path)
            torch.index_select(t, 0, flat.to(t.device), out=spare)
            cache.entries[path], cache.spares[path] = spare, t
    return cache


@torch.no_grad()
def _beam_search(model, prompt, max_len, num_beams, eos_id, length_penalty):
    B, P = prompt.shape
    k = num_beams
    dev = prompt.device
    bufs = torch.zeros((B, k, max_len), dtype=torch.long, device=dev)
    bufs[:, :, :P] = prompt[:, None]
    scores = beam_init_scores(B, k, dev)
    fin_bufs = torch.zeros_like(bufs)
    fin_scores = torch.full((B, k), -torch.inf, device=dev)
    for t in range(P, max_len):
        logits = model(bufs.reshape(B * k, max_len))
        logp = torch.log_softmax(logits[:, t - 1].float(), dim=-1).reshape(
            B, k, -1)
        if eos_id is None:
            bufs, scores, _ = beam_expand(logp, bufs, scores, t)
        else:
            bufs, scores, fin_bufs, fin_scores, _ = beam_step_eos(
                logp, bufs, scores, fin_bufs, fin_scores, t, P, eos_id,
                length_penalty)
    return beam_finalize(bufs, scores, fin_bufs, fin_scores, P, eos_id,
                         length_penalty)


@torch.no_grad()
def _beam_search_cached(model, cache, prompt, max_len, num_beams, eos_id,
                        length_penalty):
    """The cached beam search: the prompt prefilled once at batch B, the
    cache's rows repeated to B * k (row b * k + j is batch b's beam j, as
    ``bufs.reshape(B * k, L)``), then one token a hypothesis a step, the
    cache reordered by beam origin after each expansion but the last."""
    B, P = prompt.shape
    k = num_beams
    dev = prompt.device
    bufs = torch.zeros((B, k, max_len), dtype=torch.long, device=dev)
    bufs[:, :, :P] = prompt[:, None]
    scores = beam_init_scores(B, k, dev)
    fin_bufs = torch.zeros_like(bufs)
    fin_scores = torch.full((B, k), -torch.inf, device=dev)
    feed = _decode_feed(model)
    cache = _prefill_cache(feed, cache, prompt)
    cache = cache.map(lambda t: t.repeat_interleave(k, dim=0))
    for t in range(P, max_len):
        tok = bufs.reshape(B * k, max_len)[:, t - 1:t]
        cache, logits = feed(cache, tok, t - 1)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, k, -1)
        if eos_id is None:
            bufs, scores, origin = beam_expand(logp, bufs, scores, t)
        else:
            bufs, scores, fin_bufs, fin_scores, origin = beam_step_eos(
                logp, bufs, scores, fin_bufs, fin_scores, t, P, eos_id,
                length_penalty)
        if t < max_len - 1:
            cache = beam_reorder_cache(cache, origin, B, k)
    return beam_finalize(bufs, scores, fin_bufs, fin_scores, P, eos_id,
                         length_penalty)


def beam_search(model, prompt, max_len, num_beams=4, eos_id=None,
                length_penalty=0.0, use_cache=False):
    """Beam-search decoding for the causal LMs: ``num_beams`` hypotheses
    re-forwarded together each step through the fixed-length buffer of
    :func:`generate`. Returns ``(sequences, scores)``: (B, max_len) best
    hypotheses and their summed token log-probs (length-normalised when
    ``length_penalty > 0``). ``num_beams=1`` with no EOS is greedy decoding.

    ``eos_id``: a hypothesis that emits it moves into a finished pool (k
    slots, merged by normalised score, never evicted by later live
    expansions) and pads with ``eos_id``; live beams go on with the EOS
    move excluded. ``length_penalty``: GNMT's ``score / gen_len**alpha``.
    ``use_cache``: the cached search (dense GPT and LLaMA), the caches
    reordered by beam origin after each expansion; the re-forward search's
    sequences and scores."""
    B, P = prompt.shape
    if not 1 <= P < max_len:
        raise ValueError(
            f"prompt length {P} must be in [1, max_len={max_len})")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0, got {length_penalty}")
    _check_position_capacity(model, max_len)
    prompt = _prompt(model, prompt)
    args = (int(max_len), int(num_beams),
            None if eos_id is None else int(eos_id), float(length_penalty))
    if use_cache:
        # A batch-B cache: the prompt's prefill is shared by the beams.
        return _beam_search_cached(model, init_decode_cache(model, B),
                                   prompt, *args)
    return _beam_search(model, prompt, *args)


__all__ = ["generate", "beam_search", "sample_or_argmax", "beam_init_scores",
           "beam_expand", "beam_best", "beam_step_eos", "beam_finalize",
           "beam_reorder_cache", "init_decode_cache", "prefill_prefix"]

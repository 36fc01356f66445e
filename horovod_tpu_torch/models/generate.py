"""Autoregressive generation for the port's causal LMs (GPT, LLaMA, the MoE
GPT): greedy and sampled decoding and beam search.

Port of the JAX package's ``models/generate.py``, its re-forward half: each
step runs the model on the whole fixed-length buffer (static shapes; the
causal structure ignores the tail not yet written), under
``torch.no_grad()``. JAX compiles the loop into one program; here it is an
eager Python loop, one forward per generated token, with the model's own
kernels (flash attention when the model has ``use_flash``).

Sampling takes a ``torch.Generator`` (``rng``, on the logits' device) where
JAX takes a PRNG key: the same seed gives the same stream, but not JAX's
stream. Greedy decoding and beam search draw nothing and follow JAX's
tokens.

Waiting for A15 (the KV cache): ``use_cache=True``, ``prefix_state``,
:func:`init_decode_cache`, :func:`prefill_prefix` and
:func:`beam_reorder_cache` raise ``NotImplementedError`` naming it.
"""

import numpy as np
import torch

from horovod_tpu_torch.parallel.tp import _not_yet


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
    (``config.max_position_embeddings``, where the model has one)."""
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
    - ``use_cache`` and ``prefix_state``: the KV-cached decode, A15's.

    Returns (B, max_len) int64 token ids: the prompt, then the generated
    tokens."""
    B, P = prompt.shape
    if not 1 <= P <= max_len:
        raise ValueError(
            f"prompt length {P} must be in [1, max_len={max_len}] "
            "(position 0 must come from the prompt)")
    check_sampling(temperature, rng, top_k, top_p)
    if use_cache or prefix_state is not None:
        _not_yet("the KV-cached decode (use_cache, prefix_state)", "A15")
    _check_position_capacity(model, max_len)
    return _generate(model, _prompt(model, prompt), int(max_len),
                     float(temperature), rng, int(top_k), float(top_p),
                     None if eos_id is None else int(eos_id))


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
    """The decode cache's rows reordered by beam origin (A15)."""
    _not_yet("reordering a decode cache by beam (beam_reorder_cache)",
             "A15")


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
    ``use_cache=True`` (the KV-cached search) is A15's."""
    B, P = prompt.shape
    if not 1 <= P < max_len:
        raise ValueError(
            f"prompt length {P} must be in [1, max_len={max_len})")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0, got {length_penalty}")
    if use_cache:
        _not_yet("the KV-cached beam search (use_cache=True)", "A15")
    _check_position_capacity(model, max_len)
    return _beam_search(model, _prompt(model, prompt), int(max_len),
                        int(num_beams),
                        None if eos_id is None else int(eos_id),
                        float(length_penalty))


def init_decode_cache(decoder, *args, **kwargs):
    """A zeroed decode cache for a decode-mode model (A15)."""
    _not_yet("the decode cache (init_decode_cache)", "A15")


def prefill_prefix(model, prefix):
    """The decode cache of a fixed prompt prefix (A15)."""
    _not_yet("prefix caching (prefill_prefix)", "A15")


__all__ = ["generate", "beam_search", "sample_or_argmax", "beam_init_scores",
           "beam_expand", "beam_best", "beam_step_eos", "beam_finalize",
           "beam_reorder_cache", "init_decode_cache", "prefill_prefix"]

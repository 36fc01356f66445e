"""Speculative decoding: a draft model proposes, the target verifies.

Port of the JAX package's ``models/speculative.py``, its re-forward half:
the acceptance-rejection scheme of Leviathan et al. 2023 / Chen et al. 2023.
A draft model proposes ``gamma`` tokens one forward at a time, the target
scores all of them in ONE forward, and the test keeps a prefix of the
proposals such that the output distribution is exactly the target's
(greedy output equals target-only greedy decoding token for token).

Each block re-forwards a fixed buffer of ``max_len + gamma + 1`` columns;
per-row cursors advance by each row's accepted count, so rows progress
independently through masked column writes. The loop runs eagerly, a
block at a time, until every row is done.

Acceptance: draft token ``x_i ~ q_i`` is accepted iff
``u_i * q_i(x_i) < p_i(x_i)``; at the first rejection the replacement is
drawn from ``max(p - q, 0)`` renormalised; after ``gamma`` acceptances a
bonus token comes from the target's next position. The uniforms ``u`` are
passed in; the draws come from a ``torch.Generator`` where JAX takes keys.

The cached route (``use_cache=True``): the draft takes ``gamma`` one-token
cached feeds, the target verifies the block in ONE chunked cached feed of
``gamma + 1`` tokens, and a rejection is a rewind of the cache cursors
(:func:`rewind_cache`; the stale rows past the cursor are masked, then
overwritten). The rows advance in lockstep, by the block's smallest
accepted count: the cursor is one host int for the batch.
"""

import torch

from horovod_tpu_torch.models.generate import (_check_position_capacity,
                                               _chunk_feed, _decode_feed,
                                               _filter_logits, _prefill_cache,
                                               _prompt, categorical,
                                               check_sampling,
                                               init_decode_cache)


def _spec_probs(logits, temperature, top_k, top_p):
    """The sampling distribution as fp32 probabilities (tempered, then
    filtered, as ``sample_or_argmax``), over (..., V) logits."""
    shape = logits.shape
    flat = logits.reshape(-1, shape[-1]).float() / temperature
    return torch.softmax(_filter_logits(flat, top_k, top_p),
                         dim=-1).reshape(shape)


def speculative_accept(p, q, x, u, rng=None):
    """Acceptance-rejection for one speculation block.

    ``p``: (B, gamma+1, V) fp32 TARGET probabilities at the proposals'
    positions and the bonus position; ``q``: (B, gamma, V) the DRAFT's the
    proposals were drawn from; ``x``: (B, gamma) the proposals; ``u``:
    (B, gamma) uniforms for the tests; ``rng``: the generator of the
    residual and bonus draws. Returns ``(tokens, count)``: (B, gamma+1)
    tokens whose first ``count`` (1 to gamma+1) are valid, the accepted
    prefix and then the correction or the bonus."""
    B, gamma = x.shape
    idx = x[..., None].long()
    px = p[:, :gamma].gather(-1, idx)[..., 0]
    qx = q.gather(-1, idx)[..., 0]
    # STRICT u*q < p: still min(1, p/q), and a token outside the target's
    # filtered support (p(x) = 0) is never accepted, even at u = 0.
    accept = u * qx < px
    k = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    rej = torch.clamp(k, max=gamma - 1)
    rows = torch.arange(B, device=p.device)
    p_rej, q_rej = p[rows, rej], q[rows, rej]
    resid = torch.clamp(p_rej - q_rej, min=0.0)
    z = resid.sum(dim=-1, keepdim=True)
    # z == 0 (p == q at the rejection position) falls back to p
    resid = torch.where(z > 0, resid / torch.clamp(z, min=1e-30), p_rej)
    y_resid = categorical(torch.clamp(resid, min=1e-30), rng)
    y_bonus = categorical(torch.clamp(p[:, gamma], min=1e-30), rng)
    y = torch.where(k == gamma, y_bonus, y_resid)
    toks = torch.cat([x.long(), torch.zeros_like(x[:, :1]).long()], dim=1)
    slots = torch.arange(gamma + 1, device=p.device)[None]
    toks = torch.where(slots == k[:, None], y[:, None], toks)
    return toks, k + 1


def _greedy_accept(p_logits, x):
    """Greedy acceptance: proposals are accepted while they equal the
    target's argmax; the first mismatch (or the bonus slot) takes the
    target's argmax, so the block is the target's own greedy tokens."""
    gamma = x.shape[1]
    tgt = torch.argmax(p_logits, dim=-1)                 # (B, gamma+1)
    accept = x == tgt[:, :gamma]
    k = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    return tgt, k + 1


def _eos_pad(out, P, eos_id):
    """Everything after a row's first GENERATED eos becomes eos (the
    fixed-length contract of ``generate``)."""
    if eos_id is None:
        return out
    gcols = torch.arange(out.shape[1], device=out.device)[None]
    is_eos = ((out == eos_id) & (gcols >= P)).long()
    after = torch.cumsum(is_eos, dim=1) - is_eos > 0
    return torch.where(after & (gcols >= P), torch.full_like(out, eos_id),
                       out)


def rewind_cache(cache, new_idx):
    """Move every layer's decode-cache cursor to ``new_idx``, the rejection
    primitive: the K/V rows past it stay as they are, masked by the decode
    attend (``valid = position <= idx + i``) until a later feed overwrites
    them. Returns ``cache``."""
    for path, _ in cache.items():
        if path.rsplit("/", 1)[-1] == "idx":
            cache.entries[path] = int(new_idx)
    return cache


@torch.no_grad()
def _speculative(target, draft, prompt, max_len, gamma, temperature, rng,
                 top_k, top_p, eos_id, width):
    B, P = prompt.shape
    dev = prompt.device
    cols = torch.arange(width, device=dev)[None]          # (1, W)
    rows = torch.arange(B, device=dev)
    buf = torch.zeros((B, width), dtype=torch.long, device=dev)
    buf[:, :P] = prompt
    pos = torch.full((B,), P, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    nblk = 0
    while not bool(done.all()):
        xs, qs = [], []
        for i in range(gamma):
            lg = draft(buf)[rows, pos + i - 1]              # (B, V)
            if temperature == 0.0:
                nxt = torch.argmax(lg, dim=-1)
            else:
                qfull = _spec_probs(lg, temperature, top_k, top_p)
                nxt = categorical(torch.clamp(qfull, min=1e-30), rng)
                qs.append(qfull)
            buf = torch.where(cols == (pos + i)[:, None], nxt[:, None], buf)
            xs.append(nxt)
        xs = torch.stack(xs, dim=1)                         # (B, gamma)
        # ONE target forward scores every proposal and the bonus position
        idx = pos[:, None] - 1 + torch.arange(gamma + 1, device=dev)[None]
        p_logits = target(buf)[rows[:, None], idx]          # (B, g+1, V)
        if temperature == 0.0:
            toks, count = _greedy_accept(p_logits, xs)
        else:
            p = _spec_probs(p_logits, temperature, top_k, top_p)
            u = torch.rand(xs.shape, generator=rng, device=dev)
            toks, count = speculative_accept(p, torch.stack(qs, dim=1), xs,
                                             u, rng)
        # clamp to the room left; finished rows write nothing
        count = torch.where(done, 0, torch.minimum(count, max_len - pos))
        in_block = (cols >= pos[:, None]) & (cols < (pos + count)[:, None])
        slot = torch.clamp(cols - pos[:, None], 0, gamma)
        buf = torch.where(in_block, toks.gather(1, slot), buf)
        if eos_id is not None:
            # a generated EOS in the block finishes the row; _eos_pad pads
            done = done | (in_block & (buf == eos_id)).any(dim=1)
        pos = pos + count
        done = done | (pos >= max_len)
        nblk += 1
    return _eos_pad(buf[:, :max_len], P, eos_id), nblk


@torch.no_grad()
def _speculative_cached(target, draft, t_cache, d_cache, prompt, max_len,
                        gamma, temperature, rng, top_k, top_p, eos_id,
                        width):
    """The cached speculative decode; returns ``(buffer, n_blocks)``."""
    B, P = prompt.shape
    dev = prompt.device
    cols = torch.arange(width, device=dev)[None]
    buf = torch.zeros((B, width), dtype=torch.long, device=dev)
    buf[:, :P] = prompt
    t_chunk, d_chunk = _chunk_feed(target), _chunk_feed(draft)
    d_feed = _decode_feed(draft)
    # prompt tokens 0..P-2 enter each cache; the cursors land at P - 1
    t_cache = _prefill_cache(t_chunk, t_cache, prompt)
    d_cache = _prefill_cache(d_chunk, d_cache, prompt)
    pos = P
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    nblk = 0
    while True:
        xs, qs = [], []
        for i in range(gamma):
            d_cache, lg = d_feed(d_cache, buf[:, pos + i - 1:pos + i],
                                 pos + i - 1)
            if temperature == 0.0:
                nxt = torch.argmax(lg, dim=-1)
            else:
                qfull = _spec_probs(lg, temperature, top_k, top_p)
                nxt = categorical(torch.clamp(qfull, min=1e-30), rng)
                qs.append(qfull)
            buf[:, pos + i] = nxt
            xs.append(nxt)
        xs = torch.stack(xs, dim=1)                         # (B, gamma)
        # ONE chunked target feed verifies the block: the tokens at
        # positions pos-1 .. pos+gamma-1
        t_cache, p_logits = t_chunk(t_cache, buf[:, pos - 1:pos + gamma],
                                    pos - 1)
        if temperature == 0.0:
            toks, count = _greedy_accept(p_logits, xs)
        else:
            p = _spec_probs(p_logits, temperature, top_k, top_p)
            u = torch.rand(xs.shape, generator=rng, device=dev)
            toks, count = speculative_accept(p, torch.stack(qs, dim=1), xs,
                                             u, rng)
        # lockstep: the smallest accepted count of the active rows, bounded
        # by the room left
        count = torch.where(done, gamma + 1, count)
        adv = min(int(count.min()), max_len - pos)
        per_row = torch.where(done, 0, adv)
        in_block = (cols >= pos) & (cols < pos + per_row[:, None])
        slot = torch.clamp(cols - pos, 0, gamma).expand(B, -1)
        buf = torch.where(in_block, toks.gather(1, slot), buf)
        if eos_id is not None:
            done = done | (in_block & (buf == eos_id)).any(dim=1)
        # The draft never fed its last proposal: feed the committed block
        # again from pos - 1 before the rewind, or a fully accepted block
        # would leave a row the draft never wrote under its cursor.
        d_cache = rewind_cache(d_cache, pos - 1)
        d_cache, _ = d_chunk(d_cache, buf[:, pos - 1:pos + gamma], pos - 1)
        # tokens 0..pos+adv-2 are committed; pos+adv-1 is the next input
        rewind_cache(t_cache, pos - 1 + adv)
        rewind_cache(d_cache, pos - 1 + adv)
        pos += adv
        nblk += 1
        done = done | (pos >= max_len)
        if bool(done.all()):
            return _eos_pad(buf[:, :max_len], P, eos_id), nblk


def speculative_generate(target_model, draft_model, prompt, max_len,
                         gamma=4, temperature=0.0, rng=None, top_k=0,
                         top_p=1.0, eos_id=None, use_cache=False,
                         return_stats=False):
    """Generate up to ``max_len`` total tokens with the TARGET model's
    output distribution at a fraction of its forwards.

    - ``target_model``/``draft_model``: causal LMs with ``generate``'s
      contract, both with position capacity for ``max_len + gamma + 1``.
    - ``gamma``: proposals a block; a block costs ``gamma`` draft forwards
      and ONE target forward and yields 1 to gamma + 1 tokens.
    - ``temperature=0``: the output equals target-only greedy decoding.
      Otherwise the tokens follow the target's tempered, filtered
      distribution exactly; ``rng`` (a ``torch.Generator``) draws them.
    - ``top_k``/``top_p``/``eos_id``: as in ``generate``.
    - ``use_cache=True``: the cached speculation (dense GPT and LLaMA):
      one-token cached draft feeds, ONE chunked cached target feed a
      block, rejections rewind the cursors; the rows advance in lockstep
      by the block's smallest accepted count. Greedy output still equals
      target-only greedy decoding.

    Returns (B, max_len) token ids; with ``return_stats``, ``(tokens,
    {"blocks": n})``, n the speculation blocks (= target forwards)."""
    B, P = prompt.shape
    if not 1 <= P <= max_len:
        raise ValueError(
            f"prompt length {P} must be in [1, max_len={max_len}]")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    check_sampling(temperature, rng, top_k, top_p)
    width = int(max_len) + int(gamma) + 1
    _check_position_capacity(target_model, width)
    _check_position_capacity(draft_model, width)
    prompt = _prompt(target_model, prompt)
    args = (int(max_len), int(gamma), float(temperature), rng, int(top_k),
            float(top_p), None if eos_id is None else int(eos_id), width)
    if use_cache:
        out, nblk = _speculative_cached(
            target_model, draft_model, init_decode_cache(target_model, B),
            init_decode_cache(draft_model, B), prompt, *args)
    else:
        out, nblk = _speculative(target_model, draft_model, prompt, *args)
    if return_stats:
        return out, {"blocks": nblk}
    return out


__all__ = ["speculative_accept", "speculative_generate", "rewind_cache"]

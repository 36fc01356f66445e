"""Sequence parallelism: Ulysses and ring attention, and the labels.

Port of the JAX package's ``parallel/sequence.py``. Tokens are sharded
over an in-step axis (``ops/in_step.py``; JAX's default, the flat ``hvd``
axis, is this module's ``SP_AXIS`` too); outside :func:`in_step.axes`
every function computes on its local, unsharded tensors, as JAX's do
outside ``shard_map``.

- :func:`ulysses_attention`: two all-to-alls exchange tokens for heads
  around one full-sequence attention per head shard (the flash kernels
  with ``use_flash``). Grouped K/V ride the exchange narrow when their
  head count divides the axis.
- :func:`ring_attention`: K/V blocks rotate around the axis while each rank
  combines its Q block's hop results. ``use_flash=False`` is JAX's plain
  einsum ring with an online softmax. ``use_flash=True`` is JAX's
  ``_ring_flash``, factored into per-hop functions:
  :func:`ring_hop_forward` (the flash forward kernel on one K/V block),
  :func:`ring_hop_backward` (the dQ and dK/dV kernels against the
  ring-wide lse, with the GQA broadcast and fold at the hop) and
  :func:`ring_combine` (the lse-weighted combination).
  :func:`ring_flash_forward` and :func:`ring_flash_backward` hold the
  ring's schedule once, for one rank over a process group
  (:func:`group_shift`, ``batch_isend_irecv``) as for every rank of a ring
  in one process (:func:`rotate`); the next hop's transfer is posted
  before the current hop's kernel, so the two overlap. The ring
  (:class:`_RingFlash`, one ``torch.autograd.Function`` whose backward is
  JAX's ``_ring_flash_bwd``) runs them over the axis group. Under causal
  masking a hop from a rank ahead is skipped on the host (JAX's
  ``lax.cond``; skipping it leaves the combination as JAX's zero-weight
  hop leaves it, bit for bit). Narrow GQA blocks and their gradient
  accumulators rotate narrow. On CUDA the hops are the sm_90a kernels
  (``ops/kernels/flash_attention.py``); on the CPU their plain block
  versions, in the role of JAX's ``_jnp_block_fwd``/``_bwd``.
- :func:`next_token_labels`: each shard's last label is the next shard's
  first token, fetched with one ``ppermute``.
"""

import math

import torch

from horovod_tpu_torch.common.topology import HVD_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.ops.kernels.flash_attention import (
    _from3, _to3, fa_backward, fa_forward, flash_attention, gqa_fold3,
    gqa_repeat3)

SP_AXIS = HVD_AXIS    # JAX's default: sequence parallelism over the world

NEG_BIG = -1e30       # the ring's "no block seen yet" running max


def broadcast_kv_heads(q, k, v):
    """Grouped K/V heads repeated up to the query heads (as they are for
    MHA)."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide query heads "
                         f"{q.shape[2]}")
    g = q.shape[2] // k.shape[2]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def local_attention(q, k, v, causal=False):
    """Plain softmax attention in fp32 on local (B, L, H, D) tensors, the
    oracle of the parallel schemes (end-aligned causal mask); grouped K/V
    are broadcast here."""
    k, v = broadcast_kv_heads(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def ulysses_attention(q, k, v, axis_name=SP_AXIS, causal=False,
                      use_flash=False):
    """DeepSpeed-Ulysses: (B, L/n, H, D) token shards -> (B, L, H/n, D)
    head shards by one all-to-all each, full-sequence attention (the flash
    kernels with ``use_flash``), and back."""
    attn = flash_attention if use_flash else local_attention
    if not in_step.axis_bound(axis_name):
        return attn(q, k, v, causal=causal)
    n = in_step.axis_size(axis_name)
    if q.shape[2] % n:
        raise ValueError(f"num heads {q.shape[2]} not divisible by sp={n}")
    if k.shape[2] % n:
        # Grouped heads that do not split over sp: broadcast first.
        k, v = broadcast_kv_heads(q, k, v)

    def scatter_heads(t):
        return in_step.alltoall(t, axis_name, split_axis=2, concat_axis=1)

    oh = attn(scatter_heads(q), scatter_heads(k), scatter_heads(v),
              causal=causal)
    return in_step.alltoall(oh, axis_name, split_axis=1, concat_axis=2)


def next_token_labels(ids, axis_name=SP_AXIS, pad_id=-100):
    """Next-token labels of ``ids`` (B, L_local): the ids shifted left by
    one; the last global position gets ``pad_id`` (the chunked loss
    excludes labels < 0). Under a bound sequence axis each shard's last
    label is the next shard's first token (one ``ppermute``);
    ``axis_name=None`` or unbound: the plain shift."""
    pad = torch.full_like(ids[:, :1], pad_id)
    if not in_step.axis_bound(axis_name):
        return torch.cat([ids[:, 1:], pad], dim=1)
    n = in_step.axis_size(axis_name)
    idx = in_step.axis_index(axis_name)
    first_next = in_step.ppermute(ids[:, :1].contiguous(),
                                  [((i + 1) % n, i) for i in range(n)],
                                  axis_name)
    boundary = pad if idx == n - 1 else first_next
    return torch.cat([ids[:, 1:], boundary], dim=1)


# ---------------------------------------------------------------------------
# The flash ring, hop by hop
# ---------------------------------------------------------------------------

def ring_hop_plan(idx, s, n, causal):
    """(runs, causal_hop) of hop ``s`` at ring position ``idx``: the block
    of rank ``(idx + s) % n``; under causal masking hop 0 is the causal
    diagonal, a block from an earlier rank is whole and non-causal, and one
    from a rank ahead is masked whole (skipped)."""
    if not causal:
        return True, False
    if s == 0:
        return True, True
    return (idx + s) % n < idx, False


def _gqa(heads, kv_heads):
    return heads is not None and kv_heads is not None and heads != kv_heads


def ring_hop_forward(q3, ks, vs, causal, scale, heads=None, kv_heads=None):
    """(o_b, lse_b) of one hop on (BH, L, D) blocks: the flash forward; with
    ``kv_heads < heads`` the K/V blocks stay narrow (B * kv_heads rows) and
    the kernel reads each for its query heads."""
    if _gqa(heads, kv_heads):
        return fa_forward(q3, ks, vs, causal, scale, heads=heads,
                          kv_heads=kv_heads)
    return fa_forward(q3, ks, vs, causal, scale)


def ring_hop_backward(q3, ks, vs, out3, lse, do3, causal, scale, heads=None,
                      kv_heads=None):
    """One hop's (dq, dk, dv) against the ring-wide ``lse``: p = exp(s -
    lse), so the hops' contributions sum to the exact gradient. Narrow K/V
    are broadcast for the MHA-shaped backward kernels and dK/dV folded back
    onto the narrow rows, so the accumulators rotate narrow."""
    if _gqa(heads, kv_heads):
        b, g = q3.shape[0] // heads, heads // kv_heads
        ks = gqa_repeat3(ks, b, kv_heads, g)
        vs = gqa_repeat3(vs, b, kv_heads, g)
    dq, dk, dv = fa_backward(q3, ks, vs, out3, lse, do3, causal, scale)
    if _gqa(heads, kv_heads):
        dk, dv = gqa_fold3(dk, b, kv_heads, g), gqa_fold3(dv, b, kv_heads, g)
    return dq, dk, dv


def ring_init(q3):
    """The combination's start: (running max, norm, fp32 accumulator)."""
    bh, L, d = q3.shape
    return (torch.full((bh, L), NEG_BIG, dtype=torch.float32,
                       device=q3.device),
            torch.zeros((bh, L), dtype=torch.float32, device=q3.device),
            torch.zeros((bh, L, d), dtype=torch.float32, device=q3.device))


def ring_combine(state, o_b, lse_b):
    """Fold one visible hop's (o_b, lse_b) into ``state`` by its lse
    weight, in fp32."""
    m, norm, acc = state
    m_new = torch.maximum(m, lse_b)
    corr = torch.exp(m - m_new)
    w = torch.exp(torch.clamp(lse_b - m_new, max=0.0))
    return (m_new, norm * corr + w,
            acc * corr[..., None] + w[..., None] * o_b.float())


def ring_output(state, dtype):
    """(out in ``dtype``, the ring-wide fp32 lse) of a finished
    combination."""
    m, norm, acc = state
    norm = norm.clamp_min(1e-30)
    return (acc / norm[..., None]).to(dtype), m + torch.log(norm)


# ---------------------------------------------------------------------------
# The ring's schedule
# ---------------------------------------------------------------------------

class Rotated:
    """A shift already done: ``wait()`` returns its blocks."""

    def __init__(self, blocks):
        self.blocks = blocks

    def wait(self):
        return self.blocks


def rotate(blocks):
    """The ring's shift among virtual ranks in one process: ``blocks`` holds
    one list of tensors per rank in ring order, and rank r takes rank
    r + 1's."""
    return Rotated(blocks[1:] + blocks[:1])


class _Posted:
    def __init__(self, shift):
        self.shift = shift

    def wait(self):
        return [self.shift.wait()]


def group_shift(group, n, idx):
    """The ring's shift over ``group``, of ``n`` ranks with this one at
    ``idx``: ``blocks`` holds this rank's one list of tensors, sent to the
    previous rank and received from the next with ``batch_isend_irecv``,
    all posted at once. A ring of one keeps its blocks."""
    if n == 1:
        return rotate
    return lambda blocks: _Posted(in_step.Shift(blocks[0], group,
                                                (idx - 1) % n, (idx + 1) % n))


def ring_flash_forward(q3s, k3s, v3s, idxs, n, causal, scale, shift,
                       heads=None, kv_heads=None, hop_forward=None):
    """The flash ring's forward for the ranks at positions ``idxs`` of a
    ring of ``n`` (this rank over a process group, or every rank of the
    ring in one process), on their (BH, L, D) blocks: at hop s each rank
    runs its hop on the K/V block of rank ``idx + s`` (:func:`ring_hop_plan`)
    and folds it into its combination, while ``shift`` (:func:`group_shift`
    or :func:`rotate`) brings the next blocks, posted before the hop's
    kernel. ``hop_forward`` replaces :func:`ring_hop_forward`. Returns each
    rank's (out, ring-wide lse) and its number of hops."""
    hop_forward = hop_forward or ring_hop_forward
    states = [ring_init(q) for q in q3s]
    kv, hops = [[k, v] for k, v in zip(k3s, v3s)], [0] * len(idxs)
    for s in range(n):
        nxt = shift(kv) if s != n - 1 else None
        for j, idx in enumerate(idxs):
            runs, diag = ring_hop_plan(idx, s, n, causal)
            if runs:
                states[j] = ring_combine(states[j], *hop_forward(
                    q3s[j], *kv[j], diag, scale, heads, kv_heads))
                hops[j] += 1
        if nxt is not None:
            kv = nxt.wait()
    return [ring_output(st, q.dtype) for st, q in zip(states, q3s)], hops


def ring_flash_backward(q3s, k3s, v3s, outs, lses, do3s, idxs, n, causal,
                        scale, shift, heads=None, kv_heads=None,
                        hop_backward=None):
    """The flash ring's backward (JAX's ``_ring_flash_bwd``) for the ranks
    of :func:`ring_flash_forward`: each hop's gradients against its rank's
    ring-wide lse; the K/V blocks rotate n - 1 times and the fp32 dK/dV
    accumulators, which travel with their block, n times, home. The next
    K/V transfer is posted before the hop's kernels, the accumulators'
    after their sum. ``hop_backward`` replaces :func:`ring_hop_backward`.
    Returns the fp32 (dq, dk, dv) lists."""
    hop_backward = hop_backward or ring_hop_backward
    # A row that sees no key carries lse ~ NEG_BIG: keep exp(s - lse)
    # finite there (its hops are masked whole).
    lses = [torch.where(lse > -1e29, lse, 0.0) for lse in lses]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in q3s]
    acc = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            for _ in range(2)] for k in k3s]
    kv, pending = [[k, v] for k, v in zip(k3s, v3s)], None
    for s in range(n):
        nxt = shift(kv) if s != n - 1 else None
        grads = []
        for j, idx in enumerate(idxs):
            runs, diag = ring_hop_plan(idx, s, n, causal)
            grads.append(hop_backward(
                q3s[j], *kv[j], outs[j], lses[j], do3s[j], diag, scale,
                heads, kv_heads) if runs else None)
        if pending is not None:
            acc = pending.wait()
        for j, g in enumerate(grads):
            if g is not None:
                dq[j] += g[0].float()
                acc[j][0] += g[1].float()
                acc[j][1] += g[2].float()
        pending = shift(acc)
        if nxt is not None:
            kv = nxt.wait()
    acc = pending.wait()
    return dq, [a[0] for a in acc], [a[1] for a in acc]


class _RingFlash(torch.autograd.Function):
    """The flash ring on (BH, L, D) tensors over one axis group."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, group, n, idx, scale, heads,
                kv_heads):
        ((out, lse),), _ = ring_flash_forward(
            [q3], [k3], [v3], [idx], n, causal, scale,
            group_shift(group, n, idx), heads, kv_heads)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.meta = (causal, group, n, idx, scale, heads, kv_heads)
        return out

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, out3, lse = ctx.saved_tensors
        causal, group, n, idx, scale, heads, kv_heads = ctx.meta
        (dq,), (dk,), (dv,) = ring_flash_backward(
            [q3], [k3], [v3], [out3], [lse], [do3.contiguous()], [idx], n,
            causal, scale, group_shift(group, n, idx), heads, kv_heads)
        return (dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype), None,
                None, None, None, None, None, None)


def ring_attention(q, k, v, axis_name=SP_AXIS, causal=False,
                   use_flash=False):
    """Ring attention over (B, L/n, H, D) token shards: exact attention
    over the full sequence with K/V rotating once around ``axis_name``.
    ``use_flash`` runs each hop through the flash kernels and combines hops
    by their lse; otherwise the plain fp32 einsum ring with an online
    softmax. Grouped K/V rotate narrow either way. Unbound: local (flash)
    attention."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} must divide query heads "
                         f"{q.shape[2]}")
    if not in_step.axis_bound(axis_name):
        if use_flash:
            return flash_attention(q, k, v, causal=causal)
        return local_attention(q, k, v, causal=causal)
    B, Lq, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    n = in_step.axis_size(axis_name)
    idx = in_step.axis_index(axis_name)
    if use_flash:
        gqa = KV != H
        group = in_step.axis_group(axis_name) if n > 1 else None
        o3 = _RingFlash.apply(_to3(q), _to3(k), _to3(v), bool(causal),
                              group, n, idx, scale, H if gqa else None,
                              KV if gqa else None)
        return _from3(o3, B, H)
    g = H // KV
    qf = q.float()
    q_pos = idx * Lq + torch.arange(Lq, device=q.device)
    perm = [(i, (i - 1) % n) for i in range(n)]
    o = q.new_zeros((B, H, Lq, D), dtype=torch.float32)
    m = torch.full((B, H, Lq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = q.new_zeros((B, H, Lq), dtype=torch.float32)
    ks, vs = k, v
    for s in range(n):
        src = (idx + s) % n
        ksf, vsf = (t.repeat_interleave(g, dim=2) if g > 1 else t
                    for t in (ks, vs))
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, ksf.float()) * scale
        if causal:
            k_pos = src * Lq + torch.arange(Lq, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(mask, scores, float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        p = torch.where(torch.isfinite(scores),
                        torch.exp(scores - safe_m[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               vsf.float())
        m = m_new
        if s != n - 1:
            ks = in_step.ppermute(ks, perm, axis_name)
            vs = in_step.ppermute(vs, perm, axis_name)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.movedim(1, 2).to(q.dtype)

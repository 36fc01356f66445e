"""The chunked next-token loss: softmax cross-entropy without the full
logits.

Port of the JAX package's ``optim/losses.py``. The plain next-token loss
builds the (B, L, V) fp32 logits: at GPT-2 small's 8 x 1024 tokens and
V = 50304, 1.65 GB for the logits alone, and as much again for each copy
the backward keeps (their softmax, their gradient), the largest memory
term of LM training. :func:`next_token_xent_chunked` runs the head and the
cross-entropy on one chunk of the sequence at a time and reduces each chunk
to two scalars at once; each chunk runs under non-reentrant
``torch.utils.checkpoint``, so the backward recomputes the chunk's logits
instead of keeping them (JAX: ``jax.checkpoint`` on the scan body). The
logits in memory are then (B, chunk, V), in both passes, at the cost of one
more head product per chunk in the backward.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_sum(head_fn, h, y):
    """The chunk's cross-entropy summed over its valid positions (labels
    not -100), in fp32."""
    return F.cross_entropy(head_fn(h).float().flatten(0, 1), y.flatten(),
                           ignore_index=-100, reduction="sum")


def next_token_xent_chunked(head_fn, hidden, labels, chunk=128):
    """Mean softmax cross-entropy of ``head_fn(hidden)`` against ``labels``
    without the full logits.

    - ``head_fn``: hidden states (B, c, H) -> logits (B, c, V), e.g. the
      model's ``GPTHead`` or ``LlamaHead`` (``model.head``), applied to
      ``model(ids, features_only=True)``;
    - ``hidden``: (B, L, H), ``L`` divisible by ``chunk``;
    - ``labels``: (B, L) int targets aligned with the positions; a label
      < 0 (-100, :func:`parallel.sequence.next_token_labels`' pad) excludes
      its position.

    Returns the fp32 mean over the valid positions (JAX divides by at least
    one).
    """
    B, L = hidden.shape[:2]
    if L % chunk:
        raise ValueError(f"sequence length {L} not divisible by "
                         f"chunk={chunk}")
    # Every label < 0 is excluded, as JAX's mask excludes it.
    labels = labels.masked_fill(labels < 0, -100)
    tot = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, L, chunk):
        tot = tot + checkpoint(_chunk_sum, head_fn, hidden[:, i:i + chunk],
                               labels[:, i:i + chunk], use_reentrant=False)
    return tot / (labels >= 0).sum().float().clamp_min(1.0)

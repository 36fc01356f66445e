"""Sequence parallelism's label helper, outside a sequence axis.

Port of the JAX package's ``parallel/sequence.py::next_token_labels`` for
tokens that are not sequence-sharded (its ``axis_name=None`` branch). The
sharded branch, which fetches each shard's boundary token from the next
shard, comes with sequence parallelism (ROADMAP A12), as Ulysses and ring
attention do.
"""

import torch

from horovod_tpu_torch.parallel.tp import _not_yet


def next_token_labels(ids, axis_name=None, pad_id=-100):
    """Next-token labels of ``ids`` (B, L): the ids shifted left by one,
    the last position ``pad_id`` (mask it out of the loss: the chunked
    loss excludes labels < 0). ``axis_name`` names a sequence-sharded axis,
    which the port does not have yet."""
    if axis_name is not None:
        _not_yet(f"next-token labels over a sequence axis ({axis_name!r})",
                 "A12")
    pad = torch.full_like(ids[:, :1], pad_id)
    return torch.cat([ids[:, 1:], pad], dim=1)

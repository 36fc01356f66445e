"""Adasum: scale-invariant gradient combination.

Port of the JAX package's ``ops/adasum.py`` (reference:
horovod/common/ops/adasum/adasum.h:103+): two gradient vectors combine as

    adasum(a, b) = (1 - a.b / (2*||a||^2)) * a  +  (1 - a.b / (2*||b||^2)) * b

with the dot product and the norms in fp32 whatever the dtype, and a list of
them pairwise in a tree: (0, 1), (2, 3), ... at each level, an odd last one
carried unchanged. That is the JAX package's order, not the reference's
recursive halving-doubling (VHDD) one.

As in the JAX package, a reduction gathers every rank's tensor once and runs
the tree locally on every rank. :func:`reduce_gathered` is that tree on a
gathered fusion bucket, (n ranks, total) as the all-gather leaves it, in
place, with per-tensor coefficients: each level is one
``kernels.adasum.combine_pairs`` call for all of its pairs of rows, which on
the card is one launch for the whole bucket (ceil(log2 n) launches a
bucket), plus two for a level whose bucket holds a tensor longer than the
level kernel's round. On a CPU tensor every combine runs the plain version.
"""

import torch

from horovod_tpu_torch.ops.kernels import _build
from horovod_tpu_torch.ops.kernels import adasum as _kernel

EPS = _kernel.EPS


def adasum_combine(a, b, eps=EPS):
    """Combine two same-shaped gradient tensors; the result has ``a``'s
    dtype."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"adasum_combine: a {tuple(a.shape)} {a.dtype} on "
                         f"{a.device} and b {tuple(b.shape)} {b.dtype} on "
                         f"{b.device} differ")
    if a.device.type == "cuda":
        # A direct call may come before hvd.init built the kernels; the
        # runtime's path (reduce_gathered) holds a lock and only loads.
        _build.build(("adasum",))
    flat_a, flat_b = a.contiguous().view(-1), b.contiguous().view(-1)
    out = torch.empty_like(flat_a)
    _kernel.combine_segments(flat_a, flat_b, out,
                             _kernel.segment_table((flat_a.numel(),)), eps)
    return out.view(a.shape)


def adasum_tree(tensors, eps=EPS):
    """Pairwise combine a list of tensors in a binary tree, in the JAX
    package's order."""
    level = list(tensors)
    if not level:
        raise ValueError("adasum_tree needs at least one tensor")
    while len(level) > 1:
        nxt = [adasum_combine(level[i], level[i + 1], eps)
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2 == 1:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def reduce_gathered(gathered, numels, eps=EPS):
    """The Adasum reduction of a gathered fusion bucket, in place.

    ``gathered``: (n, total), row r the bucket rank r packed; ``numels``: the
    bucket's tensors' sizes, in order. Each tensor is reduced on its own (its
    own coefficients at every combine), as the JAX fused path reduces each
    tensor of an Adasum bucket separately. At stride s = 1, 2, 4, ..., row i
    becomes combine(row i, row i + s) for i = 0, 2s, 4s, ... while
    i + s < n: :func:`adasum_tree`'s pairs, with the odd one carried, a
    level at a time. The result is row 0, which is returned."""
    if gathered.dim() != 2:
        raise ValueError(f"reduce_gathered: expected (ranks, total), got "
                         f"{tuple(gathered.shape)}")
    total = _kernel.segment_table(numels).total
    if total != gathered.shape[1]:
        raise ValueError(f"reduce_gathered: the tensors hold {total} "
                         f"elements, a row {gathered.shape[1]}")
    stride = 1
    while stride < gathered.shape[0]:
        _kernel.combine_pairs(gathered, numels, stride, eps)
        stride *= 2
    return gathered[0]
